"""Model: parameter bookkeeping, batched regressor stacking, QR base
projection.

Counterpart of the reference's identification/model.py `Model` class
(model.py:22-1086), redesigned for an accelerator:

  * the per-sample iDynTree regressor loop (reference model.py:370-556,
    thousands of Python<->SWIG round trips) becomes one jitted, chunked,
    vmapped call into the pure-JAX engine;
  * the structural "random regressor" Gram (reference model.py:634-830,
    a Python loop over n_dofs*1000 samples) is one batched device
    computation; the cache file format (<urdf>.regressor.npz with keys
    R, Q, RQ, PQ, n, fb, grav_only, fric, fric_sym) stays compatible;
  * base-parameter projection keeps the Gautier/Sousa pivoted-QR
    construction (reference model.py:832-1052) on the host in f64 —
    parameter space is tiny; rank decisions are data-dependent control
    flow that belongs between jitted stages;
  * the sympy symbolic base-dependency expressions are replaced by the
    numeric K matrix plus lazily formatted strings (same information,
    no symbolic algebra in the hot path).

Parameter layout (reference model.py:131-208): 10 inertial params per
link [m, m*c, Ixx, Ixy, Ixz, Iyy, Iyz, Izz] about the link frame, then
optional friction blocks [Fc(n)] [Fv(n) | Fv+(n) Fv-(n)] [off(n)] [Fs(n)].
"""

from __future__ import annotations

import os
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg as sla

from .data import Data
from .dynamics.engine import DynamicsEngine, rpy_to_base_rot, rpy_to_base_rot_np
from .models.urdf import RobotTree, joint_names_from_regressor_xml, load_urdf
from .utils import helpers

# env-gated fine-grained profiling of the streamed identify
# (FLOBAROID_PROFILE=1): per-substage wall clock with forced device
# sync, accumulated into Model.profile (reset per computeRegressors).
# Off by default — the forced syncs serialize dispatches the production
# path deliberately overlaps.
_PROFILE = bool(int(os.environ.get("FLOBAROID_PROFILE", "0")))


def _stribeck_series(vsig, vs):
    """Stribeck regressor term exp(-|v|/vs)*sign(v) on the sign-series
    velocities (reference model.py:497-503). Single shared expression
    for the regressor column AND the simulated friction torque so the
    two paths can never disagree near zero crossings of the filtered
    sign series."""
    return np.exp(-np.abs(vsig) / vs) * np.sign(vsig)


class Model:
    def __init__(
        self,
        opt: dict[str, Any],
        urdf_file: str,
        regressor_file: str | None = None,
        regressor_init: bool = True,
    ):
        self.opt = opt
        self.urdf_file = urdf_file

        joint_order = None
        if regressor_file:
            joint_order = joint_names_from_regressor_xml(regressor_file)
        self.tree: RobotTree = load_urdf(urdf_file, joint_order=joint_order)
        self.engine = DynamicsEngine(self.tree)

        self.jointNames = list(self.tree.dof_names)
        self.num_dofs = self.tree.num_dofs
        self.num_links = self.tree.num_links
        self.linkNames = list(self.tree.link_names)
        self.limits = self.tree.joint_limits(use_deg=False)
        opt.setdefault("num_dofs", self.num_dofs)

        fb = 6 if opt["floatingBase"] else 0
        self.fb = fb
        self.N_OUT = self.num_dofs + fb

        # parameter bookkeeping (reference model.py:131-208)
        self.num_model_params = self.num_links * 10
        self.num_all_params = self.num_model_params
        self.mass_params = [i * 10 for i in range(self.num_links)]
        self.inertia_params: list[int] = []
        for i in range(self.num_links):
            self.inertia_params.extend(range(i * 10 + 4, i * 10 + 10))

        nd = self.num_dofs
        self.num_identified_params = self.num_model_params
        if opt["identifyFrictionSimultaneously"]:
            self.num_identified_params += nd  # Fc
            self.num_all_params += nd
            if not opt["identifyGravityParamsOnly"]:
                if opt["identifySymmetricVelFriction"]:
                    self.num_identified_params += nd  # Fv
                    self.num_all_params += nd
                else:
                    self.num_identified_params += 2 * nd  # Fv+, Fv-
                    self.num_all_params += 2 * nd
                self.num_identified_params += nd  # tau_off
                self.num_all_params += nd
                if opt.get("stribeckVelocity", 0) > 0:
                    self.num_identified_params += nd  # Fs
                    self.num_all_params += nd
        self.friction_params_start = self.num_model_params
        if opt["identifyGravityParamsOnly"]:
            self.num_identified_params -= len(self.inertia_params)
            self.friction_params_start = self.num_model_params - len(self.inertia_params)

        self.baseNames = ["base f_x", "base f_y", "base f_z", "base m_x", "base m_y", "base m_z"]

        # a-priori standard params from URDF (+ friction from <dynamics>)
        self.xStdModel = np.concatenate(
            [self.tree.std_params(), np.zeros(self.num_all_params - self.num_model_params)]
        )
        if opt["identifyFrictionSimultaneously"]:
            self._add_friction_from_urdf(self.xStdModel)

        # indices (into the full param vector) of the identified columns
        self.identified_params: list[int] = []
        for i in range(self.num_links):
            self.identified_params.append(i * 10)  # mass
            self.identified_params.extend([i * 10 + 1, i * 10 + 2, i * 10 + 3])
            if not opt["identifyGravityParamsOnly"]:
                self.identified_params.extend(range(i * 10 + 4, i * 10 + 10))
        self.identified_params.extend(range(self.num_model_params, self.num_all_params))

        # names per identified column (for reports)
        self.param_names: list[str] = []
        comp = ["m", "cx", "cy", "cz", "Ixx", "Ixy", "Ixz", "Iyy", "Iyz", "Izz"]
        for i in range(self.num_links):
            for c in comp:
                self.param_names.append(f"{c}_{i}")
        fric_blocks = self._friction_block_names()
        for blk, cnt in fric_blocks:
            for i in range(cnt):
                self.param_names.append(f"{blk}_{i}")

        # state filled by computeRegressors / projections
        self.YStd: np.ndarray | None = None
        self.YBase: np.ndarray | None = None
        self.tau: np.ndarray | None = None
        self.torques_stack: np.ndarray | None = None
        self.torquesAP_stack: np.ndarray | None = None
        self.tauMeasured: np.ndarray | None = None
        self.contactForcesSum: np.ndarray | None = None
        self.T: np.ndarray | None = None
        self.xBase = np.array([])
        self.xBaseModel = np.array([])
        self.xStd = np.array([])
        if opt["estimateWith"] == "urdf":
            self.xStd = self.xStdModel.copy()

        self._regr_jit_cache: dict[Any, Any] = {}
        # true precision of on-device Gram/regressor values (drives the
        # QR rank threshold in computeRegressorLinDepsQR). Note JAX
        # silently truncates f64 arrays to f32 when x64 is disabled, so
        # computeDtype=float64 alone does not guarantee f64 values — the
        # rank threshold must track the ACTUAL precision or noise
        # directions read as independent (measured: rank 80 instead of
        # 64 on the 7-DOF arm when trusting the option string).
        self._gram_dtype = (
            np.float64
            if "64" in str(opt.get("computeDtype", "float32")) and jax.config.jax_enable_x64
            else np.float32
        )

        if regressor_init:
            self.computeRegressorLinDepsQR()

    def getDescriptionOfParameters(self) -> str:
        """Human-readable description of every standard parameter
        (reference model.py:210-237)."""
        names = [
            "mass", "first moment of mass (x)", "first moment of mass (y)",
            "first moment of mass (z)", "moment of inertia (xx)",
            "moment of inertia (xy)", "moment of inertia (xz)",
            "moment of inertia (yy)", "moment of inertia (yz)",
            "moment of inertia (zz)",
        ]
        out = []
        for i in range(self.num_links):
            for j, n in enumerate(names):
                out.append(f"Parameter {i * 10 + j}: {n} of link {self.linkNames[i]}")
        return "\n".join(out) + "\n"

    # ------------------------------------------------------------------
    def _friction_block_names(self):
        opt = self.opt
        nd = self.num_dofs
        blocks = []
        if opt["identifyFrictionSimultaneously"]:
            blocks.append(("Fc", nd))
            if not opt["identifyGravityParamsOnly"]:
                if opt["identifySymmetricVelFriction"]:
                    blocks.append(("Fv", nd))
                else:
                    blocks.append(("Fv+", nd))
                    blocks.append(("Fv-", nd))
                blocks.append(("off", nd))
                if opt.get("stribeckVelocity", 0) > 0:
                    blocks.append(("Fs", nd))
        return blocks

    def _add_friction_from_urdf(self, params: np.ndarray, tree: RobotTree | None = None):
        """Fill Fc/Fv slots from the URDF <dynamics> friction/damping
        (reference: helpers.addFrictionFromURDF, helpers.py:438-480)."""
        tree = tree or self.tree
        nd = self.num_dofs
        start = self.num_model_params
        for i, jname in enumerate(self.jointNames):
            j = tree.joints[tree.dof_joint_ids[tree.dof_names.index(jname)]]
            params[start + i] = j.friction
            if not self.opt["identifyGravityParamsOnly"]:
                params[start + nd + i] = j.damping
                if not self.opt["identifySymmetricVelFriction"]:
                    params[start + 2 * nd + i] = j.damping
        if self.opt.get("stribeckVelocity", 0) > 0 and not self.opt["identifyGravityParamsOnly"]:
            fs_start = self.num_all_params - nd
            for i in range(nd):
                fc = params[start + i]
                params[fs_start + i] = abs(fc) * 0.6 if abs(fc) > 0 else 0.0

    # ------------------------------------------------------------------
    # device computation
    # ------------------------------------------------------------------
    def _p0(self):
        if not _PROFILE:
            return None
        import time

        return time.perf_counter()

    def _pmark(self, name, t0, sync=None):
        """Profile mark: accumulate wall since t0 under `name`, forcing
        any pending device work on `sync` first so the time lands on the
        substage that dispatched it."""
        if t0 is None:
            return
        import time

        if sync is not None:
            try:
                jax.block_until_ready(sync)
            except Exception:
                pass
        prof = getattr(self, "profile", None)
        if prof is None:
            prof = self.profile = {}
        prof[name] = prof.get(name, 0.0) + time.perf_counter() - t0

    def _compute_dtype(self):
        return jnp.dtype(self.opt.get("computeDtype", "float32"))

    @property
    def contactForcesSum(self):
        """Flattened (N*rows,) summed contact torque contributions J^T w.
        On the fused walking path the full series stays device-resident
        (staged cfm_stack) and only materializes here on first access —
        eager consumers of the pass need just the 6 base-wrench columns
        (reference identifier.py only ever adds contacts into the base
        rows / torque estimates)."""
        if self._cf_sum_host is None and self._cf_stack_dev is not None:
            cf_stack, n_pad, N, rows = self._cf_stack_dev
            self._cf_sum_host = np.asarray(
                cf_stack, dtype=float).reshape(n_pad, rows)[:N].reshape(-1)
        return self._cf_sum_host

    @contactForcesSum.setter
    def contactForcesSum(self, v) -> None:
        self._cf_sum_host = v
        self._cf_stack_dev = None

    def _staged_put(self, tag, host_arr, put, extra_key=()):
        """Content-memoized host->device staging. Real workflows re-run
        identify on bytes that are already device-resident (bench warm
        loop, block-selection re-identification, essential-params
        passes, CAD-mode sweeps on one Model). Fingerprint the exact
        host bytes (blake2b-128 — a crc32 collision between same-shaped
        datasets would silently reuse stale device buffers, so a
        cryptographic digest is mandatory for a correctness-neutral
        cache) and skip the transfer on a hit — compute still re-runs
        every pass; only identical input bytes are never re-shipped.
        One cached entry per tag."""
        import hashlib

        a = np.ascontiguousarray(host_arr)
        fp = (a.shape, str(a.dtype), tuple(extra_key),
              hashlib.blake2b(memoryview(a).cast("B"), digest_size=16).digest())
        cache = getattr(self, "_put_cache", None)
        if cache is None:
            cache = self._put_cache = {}
        hit = cache.get(tag)
        if hit is not None and hit[0] == fp:
            return hit[1]
        cache.pop(tag, None)  # free the old device buffer before realloc
        dev = put(a)
        cache[tag] = (fp, dev)
        return dev

    def _batched_rows(
        self, Q, DQ, DDQ, BR=None, BV=None, BA=None, pi=None, sim_only=False
    ):
        """One jitted chunk: inertial regressor blocks (N, rows, 10L) and,
        when pi is given, simulated inverse-dynamics rows (N, rows).
        sim_only=True returns (None, sim) without materializing Y off
        device (streaming mode: the full (N, rows, 10L) block is ~0.85 GB
        at walkman scale)."""
        eng = self.engine
        floating = BR is not None

        def chunk_fn(Q, DQ, DDQ, BR, BV, BA, pi_arr):
            if floating:
                Y = eng.regressor_batch(Q, DQ, DDQ, BR, BV, BA)
            else:
                Y = eng.regressor_batch(Q, DQ, DDQ)
            sim = None
            if pi_arr is not None:
                sim = jnp.einsum(
                    "nrp,p->nr", Y, pi_arr, precision=jax.lax.Precision.HIGHEST
                )
            if sim_only:
                return None, sim
            return Y, sim

        key = (floating, pi is not None, sim_only)
        if key not in self._regr_jit_cache:
            self._regr_jit_cache[key] = jax.jit(chunk_fn)
        dt = self._compute_dtype()
        args = [jnp.asarray(a, dtype=dt) if a is not None else None for a in (Q, DQ, DDQ, BR, BV, BA)]
        pi_arr = jnp.asarray(pi, dtype=dt) if pi is not None else None
        if not floating:
            args[3] = args[4] = args[5] = None
        # jit with None statically folded
        fn = self._regr_jit_cache[key]
        return fn(args[0], args[1], args[2], args[3], args[4], args[5], pi_arr)

    def _gather_state(self, samples: dict, idx: np.ndarray):
        opt = self.opt
        Q = np.asarray(samples["positions"])[idx, : self.num_dofs]
        V = np.asarray(samples["velocities"])[idx, : self.num_dofs]
        A = np.asarray(samples["accelerations"])[idx, : self.num_dofs]
        if opt["identifyGravityParamsOnly"]:
            V = np.zeros_like(V)
            A = np.zeros_like(A)
        BR = BV = BA = None
        if opt["floatingBase"]:
            rpy = np.asarray(samples["base_rpy"])[idx]
            BR = rpy_to_base_rot_np(rpy)
            BV = np.asarray(samples["base_velocity"])[idx]
            BA = np.asarray(samples["base_acceleration"])[idx]
            if opt["identifyGravityParamsOnly"]:
                # gravity-only is a statics assumption: zero base motion
                # too, so the dropped inertia columns truly contribute
                # nothing (keeps the streamed Y_id @ x_id simulation
                # identical to the materialized Yin @ pi path)
                BV = np.zeros_like(BV)
                BA = np.zeros_like(BA)
        return Q, V, A, BR, BV, BA

    def _friction_columns(self, samples: dict, idx: np.ndarray, V: np.ndarray):
        """Per-sample friction regressor columns (N, rows, n_fric)
        (reference model.py:459-503). Diagonal blocks live in the joint
        rows; base wrench rows are zero."""
        opt = self.opt
        nd = self.num_dofs
        fb = self.fb
        N = len(idx)
        sign = helpers.get_friction_sign_series(samples, opt)[idx, :nd]
        cols = [sign[:, None, :] * np.eye(nd)[None, :, :]]  # Fc
        if not opt["identifyGravityParamsOnly"]:
            if opt["identifySymmetricVelFriction"]:
                cols.append(V[:, None, :] * np.eye(nd)[None, :, :])
            else:
                vp = np.where(V > 0, V, 0.0)
                vm = np.where(V < 0, V, 0.0)
                cols.append(vp[:, None, :] * np.eye(nd)[None, :, :])
                cols.append(vm[:, None, :] * np.eye(nd)[None, :, :])
            cols.append(np.broadcast_to(np.eye(nd), (N, nd, nd)).copy())  # tau_off
            if opt.get("stribeckVelocity", 0) > 0:
                vs = float(opt["stribeckVelocity"])
                vsig = helpers.get_friction_sign_velocities(samples, opt)[idx, :nd]
                cols.append(_stribeck_series(vsig, vs)[:, None, :] * np.eye(nd)[None, :, :])
        F = np.concatenate(cols, axis=2)  # (N, nd, n_fric)
        if fb:
            F = np.concatenate([np.zeros((N, fb, F.shape[2])), F], axis=1)
        return F

    def friction_torques(self, samples: dict, idx: np.ndarray, x: np.ndarray) -> np.ndarray:
        """Analytic friction torques for parameter vector x (full layout),
        shape (N, n_dofs) (reference model.py:299-330)."""
        opt = self.opt
        if not opt["identifyFrictionSimultaneously"]:
            return np.zeros((len(idx), self.num_dofs))
        nd = self.num_dofs
        V = np.asarray(samples["velocities"])[idx, :nd]
        sign = helpers.get_friction_sign_series(samples, opt)[idx, :nd]
        start = self.num_model_params
        tau = sign * x[start : start + nd]
        if not opt["identifyGravityParamsOnly"]:
            if opt["identifySymmetricVelFriction"]:
                tau = tau + V * x[start + nd : start + 2 * nd]
                off = start + 2 * nd
            else:
                vp = np.where(V > 0, V, 0.0)
                vm = np.where(V < 0, V, 0.0)
                tau = tau + vp * x[start + nd : start + 2 * nd] + vm * x[start + 2 * nd : start + 3 * nd]
                off = start + 3 * nd
            tau = tau + x[off : off + nd]
            if opt.get("stribeckVelocity", 0) > 0:
                vs = float(opt["stribeckVelocity"])
                vsig = helpers.get_friction_sign_velocities(samples, opt)[idx, :nd]
                fs = x[self.num_all_params - nd : self.num_all_params]
                # shared expression with the regressor column: simulated
                # Stribeck torque must be exactly fs * (Stribeck column)
                # or sim-vs-identify disagree near zero crossings
                tau = tau + fs * _stribeck_series(vsig, vs)
        return tau

    def simulate_dynamics(self, samples: dict, idx: np.ndarray, x: np.ndarray | None = None):
        """Inverse-dynamics rows (N, rows) for parameter vector x
        (default: a-priori URDF params), friction included
        (replaces simulateDynamicsIDynTree, reference model.py:239-331)."""
        x = self.xStdModel if x is None else x
        if len(idx) == 0:
            return np.zeros((0, self.num_dofs + self.fb))
        Q, V, A, BR, BV, BA = self._gather_state(samples, idx)
        # inertial torques via the (exact) regressor contraction Y @ pi.
        # Fixed-size chunks (padded): one compiled shape serves every
        # call — a fresh N here used to trigger a fresh multi-minute
        # compile at walkman scale — and sim_only keeps the
        # (N, rows, 10L) block out of device memory entirely
        N = len(idx)
        chunk = min(int(self.opt.get("gramChunk", 4096)), max(N, 16))
        pi = x[: self.num_model_params]
        parts = []
        for s0 in range(0, N, chunk):
            sl = slice(s0, s0 + chunk)
            n_here = len(Q[sl])
            padn = chunk - n_here

            def p(a):
                if a is None:
                    return None
                a = np.asarray(a[sl])
                if padn:
                    a = np.concatenate([a, np.repeat(a[-1:], padn, axis=0)])
                return a

            _, sim_c = self._batched_rows(
                p(Q), p(V), p(A), p(BR), p(BV), p(BA), pi=pi, sim_only=True
            )
            parts.append(np.asarray(sim_c)[:n_here])
        sim = np.concatenate(parts).astype(float)
        fric = self.friction_torques(samples, idx, x)
        sim[:, self.fb :] += fric
        return sim

    def computeRegressors(self, data: Data, only_simulate: bool = False) -> None:
        """Batched replacement of the reference's per-sample stacking loop
        (reference model.py:333-632). Fills YStd, YBase, tau,
        torques_stack, contactForcesSum, tauMeasured, T."""
        opt = self.opt
        self.data = data
        self._contract_cache = {}  # contractions are per-dataset
        self._resid_cache = {}  # residual stats are per-dataset
        self._agg_cache = {}  # Gram aggregates are per-dataset
        self._staged = None  # staged device inputs are per-dataset
        # generation token: consumers holding lazy per-dataset state
        # (identifier's lazy tau series) can detect a re-staging
        self._dataset_gen = getattr(self, "_dataset_gen", 0) + 1
        nd, fb = self.num_dofs, self.fb
        rows = nd + fb
        skip = int(opt["skipSamples"])
        N = data.num_used_samples
        idx = np.arange(N) * (skip + 1)
        samples = data.samples

        if _PROFILE:
            self.profile = {}
        _t = self._p0()
        Q, V, A, BR, BV, BA = self._gather_state(samples, idx)
        self._pmark("gather_state", _t)

        # a-priori torque simulation is only consumed when (a) torques are
        # simulated outright, (b) useAPriori needs tau_apriori, or (c) a
        # floating-base dataset carries joint-only measurements whose 6
        # base-wrench rows must be filled in from the model. A full-row
        # floating-base dataset (e.g. the walking-contact scenario) skips
        # an entire regressor pass over the data here.
        # samples['torques'] is required (read unconditionally below);
        # the gate is the plain shape comparison (advisor r3)
        tq_cols = np.asarray(samples["torques"]).shape[-1]
        need_sim = (
            opt["simulateTorques"]
            or opt["useAPriori"]
            or (opt["floatingBase"] and tq_cols < rows)
        )
        pi_urdf = self.xStdModel[: self.num_model_params]
        # the stacked Y block is not needed in streaming mode (Grams are
        # accumulated on device) nor for only_simulate — skip the large
        # device->host fetch in those cases
        streaming = not int(opt.get("materializeRegressor", 1)) and not only_simulate
        skip_y = streaming or only_simulate
        Yin = sim = None
        if streaming:
            # streaming: simulate through the staged chunk scan (the same
            # staged inputs feed the Gram scan and reporting contractions
            # — ONE host->device staging per dataset). Y_id @ x_id equals
            # Yin @ pi + friction: identified columns only drop inertia
            # columns in gravity-only mode, where V = A = 0 zeroes them.
            staged = self._stage_streaming(samples, idx, N, rows, Q, V, A, BR, BV, BA)
            if need_sim:
                _t = self._p0()
                x_id = self.xStdModel[self.identified_params]
                sim = np.nan_to_num(self._scan_contract(staged, [x_id])[0])
                self._pmark("apriori_sim", _t)
        else:
            Yin, sim = self._batched_rows(
                Q, V, A, BR, BV, BA,
                pi=pi_urdf if need_sim else None,
                sim_only=skip_y,
            )
            if Yin is not None:
                Yin = np.array(Yin, dtype=float)  # (N, rows, 10L)

            if sim is not None:
                sim = np.array(sim, dtype=float)
                sim[:, fb:] += self.friction_torques(samples, idx, self.xStdModel)
                sim = np.nan_to_num(sim)

        # measured torques. A previous computeRegressors pass may have
        # written back a SUBSAMPLED (N_used, rows) array (reference
        # model.py:583 does the same) — detect and use it directly
        tq_arr = np.asarray(samples["torques"])
        torq = np.array(tq_arr if tq_arr.shape[0] == N else tq_arr[idx])
        if opt["simulateTorques"]:
            torq = sim.copy()
        elif fb and torq.shape[1] < rows:
            torq = np.concatenate([sim[:, :6], torq], axis=1)

        # contact wrenches -> generalized torque contributions J^T w
        num_contacts = 0
        contacts_sum = np.zeros((N, rows))
        self._walk_fused = None
        fused_cf_lazy = None
        if "contacts" in samples and np.asarray(samples["contacts"]).ndim == 0:
            cdict = samples["contacts"].item(0)
            num_contacts = len(cdict)
            frames = [
                (li, np.asarray(wrench)[idx])
                for frame, wrench in cdict.items()
                if (li := self.tree.link_index.get(str(frame))) is not None
            ]
            # J^T w contracted ON DEVICE: the stacked Jacobians
            # (N, 6+nd, 6) never reach the host; the contraction result
            # is 6x smaller. With staged streaming chunks, ALL frames go
            # in one dispatch.
            if frames and streaming and staged["stacks"] is not None:
                lis = [li for li, _ in frames]
                W = np.stack([w for _, w in frames], axis=1)  # (N, F, 6)
                dtb = np.dtype(self._compute_dtype()).itemsize
                y_fits = (staged["n_pad"] * rows * self.num_identified_params
                          * dtb) <= (2 << 30)
                if not need_sim and y_fits and fb:
                    # the fused walking hot path: regressor + contact
                    # J^T w + device tau assembly + Grams in ONE
                    # dispatch; Y/cf/tau chunks stay device-resident for
                    # the rest of the pass (_walk_gram_fused docstring).
                    # Floating-base only: its cf6 return and base-wrench
                    # write-back are 6-row-wrench shaped; fixed-base
                    # contact data takes _contact_torques_sum_staged
                    add_cf = fb and not getattr(data, "contacts_in_torques", False)
                    G, g, gcf, Yst, cf_stack, tau_stack, fhost = (
                        self._walk_gram_fused(lis, staged, W, torq, add_cf)
                    )
                    staged["Ystack"] = Yst
                    staged["taum_stack"] = tau_stack
                    staged["cfm_stack"] = cf_stack
                    self._walk_fused = (G, g, gcf, fhost)
                    # only the 6 base-wrench columns cross to the host
                    # (inside the fused dispatch's single packed fetch;
                    # the host torque write-back below needs exactly
                    # them); the full (N, rows) series stays
                    # device-resident and the contactForcesSum property
                    # materializes it lazily
                    contacts_sum[:, :6] += fhost["cf6"][:N]
                    fused_cf_lazy = (cf_stack, staged["n_pad"], N, rows)
                else:
                    _t = self._p0()
                    contacts_sum += self._contact_torques_sum_staged(
                        lis, staged, W
                    )[:, -rows:]
                    self._pmark("contact_jtw", _t)
            else:
                for li, w in frames:
                    contrib = self._contact_torques(li, Q, BR, w)  # (N, 6+nd)
                    contacts_sum += contrib[:, -rows:]
        if fused_cf_lazy is not None:
            # contacts_sum holds only the base-wrench columns here; the
            # full series is device-resident behind the lazy property
            self.contactForcesSum = None
            self._cf_stack_dev = fused_cf_lazy
        else:
            self.contactForcesSum = contacts_sum.reshape(-1)

        if fb:
            if opt["simulateTorques"]:
                torq = torq + contacts_sum
            elif not getattr(data, "contacts_in_torques", False):
                # guard against re-entry: computeRegressors may run twice
                # on the same Data (block-selection scoring + estimation)
                # and the contact contribution is written back below
                torq[:, :6] += contacts_sum[:, :6]

        self.torques_stack = torq.reshape(-1)
        self.torquesAP_stack = sim.reshape(-1) if (sim is not None and opt["useAPriori"]) else np.zeros_like(self.torques_stack)
        if num_contacts or opt["simulateTorques"]:
            # write back into a COPY of the samples dict when it still
            # aliases data.measurements (advisor r2): with skipSamples>0
            # the subsampled (N_used, rows) array would otherwise replace
            # measurements['torques'] and silently corrupt later block
            # selection / reassembly passes
            if data.samples is data.measurements:
                data.samples = dict(data.measurements)
            data.samples["torques"] = torq
            if num_contacts and not opt["simulateTorques"]:
                data.contacts_in_torques = True

        self.tau = (
            self.torques_stack - self.torquesAP_stack
            if opt["useAPriori"]
            else self.torques_stack
        )
        self.tauMeasured = torq.reshape(N, rows)
        self.T = np.asarray(samples["times"])[idx]

        if only_simulate:
            return

        if not int(opt.get("materializeRegressor", 1)):
            # streaming mode: never materialize the stacked regressor —
            # accumulate Y^T Y / Y^T tau / Y^T cf Gram blocks on device
            # (BASELINE north star; SURVEY §5 long-context analogue)
            self._compute_streaming(samples, idx, N, rows, Q, V, A, BR, BV, BA)
            return

        # assemble identified columns: inertial subset + friction columns
        Yfull = Yin
        if opt["identifyGravityParamsOnly"]:
            keep = [p for p in range(self.num_model_params) if p not in set(self.inertia_params)]
            Yfull = Yin[:, :, keep]
        if opt["identifyFrictionSimultaneously"]:
            F = self._friction_columns(samples, idx, V if not opt["identifyGravityParamsOnly"] else np.asarray(samples["velocities"])[idx, :nd])
            Yfull = np.concatenate([Yfull, F], axis=2)

        self.YStd = Yfull.reshape(N * rows, self.num_identified_params)

        # when not trusting the structural regressor, re-derive base
        # projection from the data regressor (reference model.py:598-601)
        if not opt["useStructuralRegressor"]:
            self.computeRegressorLinDepsQR(self.YStd)

        if opt["useBasisProjection"]:
            self.YBase = self.YStd @ self.B
        else:
            self.YBase = self.YStd @ self.Pb

        if opt["filterRegressor"]:
            import scipy.signal as sig

            fs = float(samples["frequency"])
            b, a = sig.butter(5, float(opt["filterRegCutoff"]) / (fs / 2), btype="low")
            nb_in = self.num_base_inertial_params
            for j in range(nb_in):
                for i in range(rows):
                    self.YBase[i::rows, j] = sig.filtfilt(b, a, self.YBase[i::rows, j])


    # ------------------------------------------------------------------
    # streaming Gram accumulation (materializeRegressor=0)
    # ------------------------------------------------------------------
    def _identified_columns_traced(self, Y, V, sign, vsig):
        """Identified-column assembly as a traced function: inertial
        subset + friction blocks (mirrors the host path)."""
        import jax.numpy as jnp

        opt = self.opt
        nd = self.num_dofs
        fb = self.fb
        dt = Y.dtype
        if opt["identifyGravityParamsOnly"]:
            keep = jnp.asarray(
                [p for p in range(self.num_model_params) if p % 10 < 4]
            )
            Y = Y[:, :, keep]
        if opt["identifyFrictionSimultaneously"]:
            eye = jnp.eye(nd, dtype=dt)
            blocks = [sign[:, None, :] * eye]
            if not opt["identifyGravityParamsOnly"]:
                if opt["identifySymmetricVelFriction"]:
                    blocks.append(V[:, None, :] * eye)
                else:
                    blocks.append(jnp.where(V > 0, V, 0.0)[:, None, :] * eye)
                    blocks.append(jnp.where(V < 0, V, 0.0)[:, None, :] * eye)
                blocks.append(jnp.broadcast_to(eye, (Y.shape[0], nd, nd)))
                if opt.get("stribeckVelocity", 0) > 0:
                    vs = float(opt["stribeckVelocity"])
                    stri = jnp.exp(-jnp.abs(vsig) / vs) * jnp.sign(vsig)
                    blocks.append(stri[:, None, :] * eye)
            F = jnp.concatenate(blocks, axis=2)
            if fb:
                F = jnp.concatenate(
                    [jnp.zeros((F.shape[0], fb, F.shape[2]), dt), F], axis=1
                )
            Y = jnp.concatenate([Y, F], axis=2)
        return Y

    def _streaming_fns(self, floating: bool, vsig_same: bool = False):
        key = ("stream", floating, vsig_same)
        if key not in self._regr_jit_cache:
            import jax
            import jax.numpy as jnp

            eng = self.engine

            # the tanh Coulomb-sign series is a pure elementwise function
            # of the filtered sign velocities (helpers.py:33-43) — derive
            # it on device instead of staging a second (N, nd) array
            # (2 MB saved per pass at walking-log scale)
            sign_thresh = float(self.opt.get("frictionSignThreshold", 0.02))

            def build_Y(Q, V, A, BR, BV, BA, vsig):
                if floating:
                    Y = eng.regressor_batch(Q, V, A, BR, BV, BA)
                else:
                    Y = eng.regressor_batch(Q, V, A)
                sign = jnp.tanh(vsig / sign_thresh)
                return self._identified_columns_traced(Y, V, sign, vsig)

            def gram_from_Y(Y, tau, cf, mask):
                # per-output-channel Grams (r = wrench axis / joint): the
                # channel axis costs nothing extra in FLOPs and enables
                # WLS reweighting without a second data pass
                Yw = Y * mask[:, :, None]
                G = jnp.einsum("nrp,nrq->rpq", Yw, Yw,
                               precision=jax.lax.Precision.HIGHEST)
                g = jnp.einsum("nrp,nr->rp", Yw, tau,
                               precision=jax.lax.Precision.HIGHEST)
                gcf = jnp.einsum("nrp,nr->rp", Yw, cf,
                                 precision=jax.lax.Precision.HIGHEST)
                return G, g, gcf

            def gram_chunk(Q, V, A, BR, BV, BA, vsig, tau, cf, mask):
                Y = build_Y(Q, V, A, BR, BV, BA, vsig)
                return gram_from_Y(Y, tau, cf, mask)

            def contract_chunk(Q, V, A, BR, BV, BA, vsig, x):
                # x: (K, P) — several parameter vectors share one Y build
                # (the reporting path needs tau_hat for urdf AND the
                # identified params; building Y dominates the cost)
                Y = build_Y(Q, V, A, BR, BV, BA, vsig)
                return jnp.einsum("nrp,kp->knr", Y, x,
                                  precision=jax.lax.Precision.HIGHEST)

            nd_ = self.num_dofs

            def unpack(pk):
                """Split one packed (chunk, C) state array into the
                build_Y arguments. The state reaches the device as a
                SINGLE transfer instead of seven, and vsig is aliased
                to V when the dataset has no separately filtered sign
                velocities."""
                Q = pk[..., :nd_]
                V = pk[..., nd_: 2 * nd_]
                A = pk[..., 2 * nd_: 3 * nd_]
                i = 3 * nd_
                BR = BV = BA = None
                if floating:
                    BR = pk[..., i: i + 9].reshape(pk.shape[:-1] + (3, 3))
                    BV = pk[..., i + 9: i + 15]
                    BA = pk[..., i + 15: i + 21]
                    i += 21
                vsig = V if vsig_same else pk[..., i: i + nd_]
                return Q, V, A, BR, BV, BA, vsig

            def gram_scan(stacks, taus, cfs, n_valid):
                """All chunks in ONE dispatch: lax.scan over the chunk
                axis accumulating the per-channel Grams on device — the
                per-chunk host loop fetched 3 aggregate arrays per chunk
                (~26 MB each at 30 DOF).
                stacks: (Q,V,A[,BR,BV,BA],sign,vsig), each (n_chunks,
                chunk, ...). The padding mask is derived on device from
                the sample count `n_valid` (no (N, rows) host transfer)."""

                n_chunks, chunk = taus.shape[0], taus.shape[1]

                def step(carry, xs):
                    G, g, gcf = carry
                    st, tau, cf, k = xs
                    valid = (k * chunk + jnp.arange(chunk)) < n_valid
                    mask = jnp.broadcast_to(
                        valid.astype(tau.dtype)[:, None], tau.shape
                    )
                    Gc, gc, gcfc = gram_chunk(*unpack(st), tau, cf, mask)
                    return (G + Gc, g + gc, gcf + gcfc), None

                rows = taus.shape[-1]
                Y0 = build_Y(*unpack(stacks[0]))
                P = Y0.shape[-1]
                dt0 = Y0.dtype
                init = (
                    jnp.zeros((rows, P, P), dt0),
                    jnp.zeros((rows, P), dt0),
                    jnp.zeros((rows, P), dt0),
                )
                (G, g, gcf), _ = jax.lax.scan(
                    step, init, (stacks, taus, cfs, jnp.arange(n_chunks))
                )
                return G, g, gcf

            def build_scan(stacks):
                """Build ALL regressor chunks in one dispatch and keep
                them device-resident: (n_chunks, chunk, rows, P). Every
                later quantity of the pass (a-priori sim contraction,
                Grams, WLS residual, reporting) is then an einsum over
                this stack instead of a batched-RNEA rebuild — the Y
                build dominates every streamed dispatch. Memory-gated at
                the call site (~1.2 GB at 30 DOF)."""

                def step(carry, st):
                    return carry, build_Y(*unpack(st))

                _, Ystack = jax.lax.scan(step, 0, stacks)
                return Ystack

            def gram_scan_cached(Ystack, taus, cfs, n_valid):
                """gram_scan over prebuilt regressor chunks (no RNEA)."""

                n_chunks, chunk = taus.shape[0], taus.shape[1]

                def step(carry, xs):
                    G, g, gcf = carry
                    Y, tau, cf, k = xs
                    valid = (k * chunk + jnp.arange(chunk)) < n_valid
                    mask = jnp.broadcast_to(
                        valid.astype(tau.dtype)[:, None], tau.shape
                    )
                    Gc, gc, gcfc = gram_from_Y(Y, tau, cf, mask)
                    return (G + Gc, g + gc, gcf + gcfc), None

                rows = taus.shape[-1]
                P = Ystack.shape[-1]
                dt0 = Ystack.dtype
                init = (
                    jnp.zeros((rows, P, P), dt0),
                    jnp.zeros((rows, P), dt0),
                    jnp.zeros((rows, P), dt0),
                )
                (G, g, gcf), _ = jax.lax.scan(
                    step, init, (Ystack, taus, cfs, jnp.arange(n_chunks))
                )
                return G, g, gcf

            def contract_cached(Ystack, xs):
                return jnp.einsum(
                    "cnrp,kp->kcnr", Ystack, xs,
                    precision=jax.lax.Precision.HIGHEST,
                )

            def resid_scan(Ystack, xs, taus, cfs, n_valid):
                """Residual statistics ON DEVICE for K parameter vectors:
                rp[k,r] = ||tau_r - Y_r x_k - cf_r||^2 per channel,
                pp[k,r] = ||Y_r x_k + cf_r||^2, tp[r] = ||tau_r||^2,
                bn[k] = sum_n ||tau_n - tau_hat_n|| (per-sample norm sum,
                the reference's CAD-regularization scale). Reporting and
                WLS need norms, not the (N, rows) series — this avoids
                fetching the series to the host. Exact elementwise
                subtraction per sample: none of the Gram-identity
                cancellation that made Gram-based residuals unusable in
                f32."""

                n_chunks, chunk = taus.shape[0], taus.shape[1]
                K = xs.shape[0]
                rows = taus.shape[-1]

                def step(carry, xsin):
                    rp, pp, tp, bn = carry
                    Y, tau, cf, k = xsin
                    valid = (
                        (k * chunk + jnp.arange(chunk)) < n_valid
                    ).astype(tau.dtype)
                    pred = (
                        jnp.einsum("nrp,kp->knr", Y, xs,
                                   precision=jax.lax.Precision.HIGHEST)
                        + cf[None]
                    )
                    r = (tau[None] - pred) * valid[None, :, None]
                    p = pred * valid[None, :, None]
                    rp = rp + jnp.sum(r * r, axis=1)
                    pp = pp + jnp.sum(p * p, axis=1)
                    tp = tp + jnp.sum((tau * valid[:, None]) ** 2, axis=0)
                    bn = bn + jnp.sum(jnp.sqrt(jnp.sum(r * r, axis=2)), axis=1)
                    return (rp, pp, tp, bn), None

                dt0 = Ystack.dtype
                init = (
                    jnp.zeros((K, rows), dt0),
                    jnp.zeros((K, rows), dt0),
                    jnp.zeros(rows, dt0),
                    jnp.zeros(K, dt0),
                )
                (rp, pp, tp, bn), _ = jax.lax.scan(
                    step, init, (Ystack, taus, cfs, jnp.arange(n_chunks))
                )
                # ONE flat host-bound buffer = ONE device->host fetch
                # instead of four
                return jnp.concatenate([rp.ravel(), pp.ravel(), tp, bn])

            def contract_scan(stacks, xs):
                """tau_hat chunks for K parameter vectors in ONE dispatch:
                (n_chunks, K, chunk, rows). Padded samples yield garbage
                rows that the host slices off."""

                def step(carry, st):
                    Y = build_Y(*unpack(st))
                    return carry, jnp.einsum(
                        "nrp,kp->knr", Y, xs,
                        precision=jax.lax.Precision.HIGHEST,
                    )

                _, outs = jax.lax.scan(step, 0, stacks)
                return outs

            self._regr_jit_cache[key] = dict(
                gram_chunk=jax.jit(gram_chunk),
                contract=jax.jit(contract_chunk),
                gram_scan=jax.jit(gram_scan),
                build_scan=jax.jit(build_scan),
                gram_scan_cached=jax.jit(gram_scan_cached),
                contract_scan=jax.jit(contract_scan),
                contract_cached=jax.jit(contract_cached),
                resid_scan=jax.jit(resid_scan),
                # unjitted building blocks for the fused walking path
                # (_walk_gram_fused composes them under its own jit)
                build_Y_raw=build_Y,
                gram_from_Y_raw=gram_from_Y,
                unpack_raw=unpack,
            )
        return self._regr_jit_cache[key]

    def _walk_gram_fused(self, link_indices, staged, W, torq_raw,
                         add_cf_base: bool):
        """The walking-contact hot path in ONE device dispatch
        (reference operating point: foot-F/T identification,
        analysis_findings.md:122-129; contact stacking model.py:535-560):
        per chunk, build the regressor, compute the summed contact
        J^T w (FK shared with the regressor build), assemble the
        estimation torques on device (base wrench rows += contact
        contribution when the dataset carries net base wrenches),
        accumulate the per-channel Grams AND the a-priori residual
        statistics (the reporting pass's urdf leg — its parameter vector
        is known before the dispatch, so its stats ride this scan for
        free) — while keeping the regressor chunks, contact chunks and
        assembled-torque chunks device-resident for the rest of the pass
        (WLS residual stats, reporting contractions).

        Every host-bound scalar/aggregate is CONCATENATED into one flat
        device buffer fetched in a SINGLE device->host copy, instead of
        seven separate np.asarray fetches (aggregates, OLS scalars,
        cf6), each a synchronizing round trip.

        Returns (G, g, gcf, Ystack, cf_stack, tau_stack, host) — the
        first six device-resident, `host` a dict of fetched numpy arrays
        {G_std, g_tau, g_cf, tau_sq_rows, tau_cf_rows, cf_sq_rows,
        ap_rp, ap_pp, ap_bn, cf6}."""
        import jax.numpy as jnp

        eng = self.engine
        floating = bool(self.opt["floatingBase"])
        fns = self._streaming_fns(floating, staged["vsig_same"])
        build_Y, gram_from_Y, unpack = (
            fns["build_Y_raw"], fns["gram_from_Y_raw"], fns["unpack_raw"]
        )
        # vsig_same is part of the key (like contactSumScan): unpack and
        # build_Y bake in the packed-state layout and whether the Coulomb
        # sign velocity aliases V — reusing one Model across datasets
        # where that flips must recompile, not silently mis-unpack
        key = ("walkScan", tuple(link_indices), floating, bool(add_cf_base),
               bool(staged["vsig_same"]))
        if key not in self._regr_jit_cache:

            def cf_sample(q, br, w):
                out = jnp.zeros(6 + self.num_dofs, dtype=q.dtype)
                for f, li in enumerate(link_indices):
                    J = (eng.frame_jacobian(li, q, br) if floating
                         else eng.frame_jacobian(li, q))
                    out = out + J.T @ w[f]
                return out

            def walk_scan(stacks, Ws, torqs, n_valid, x_ap):
                n_chunks, chunk = torqs.shape[0], torqs.shape[1]
                rows = torqs.shape[-1]

                def step(carry, xs):
                    G, g, gcf, tsq, tcf, csq, rp, pp, bn, k = carry
                    st, w, torq = xs
                    args = unpack(st)
                    Y = build_Y(*args)
                    q, br = args[0], args[3]
                    if floating:
                        cf = jax.vmap(cf_sample)(q, br, w)[:, -rows:]
                    else:
                        cf = jax.vmap(
                            lambda qq, ww: cf_sample(qq, None, ww)
                        )(q, w)[:, -rows:]
                    tau = torq
                    if add_cf_base:
                        tau = tau.at[:, :6].add(cf[:, :6])
                    valid = (k * chunk + jnp.arange(chunk)) < n_valid
                    mask = jnp.broadcast_to(
                        valid.astype(tau.dtype)[:, None], tau.shape
                    )
                    Gc, gc, gcfc = gram_from_Y(Y, tau, cf, mask)
                    # per-channel OLS scalar aggregates under the SAME
                    # valid mask as the Grams (padding scheme agnostic —
                    # the unfused path sums over exactly N rows)
                    tsq = tsq + jnp.sum(mask * tau * tau, axis=0)
                    tcf = tcf + jnp.sum(mask * tau * cf, axis=0)
                    csq = csq + jnp.sum(mask * cf * cf, axis=0)
                    # a-priori residual stats (resid_scan semantics for
                    # the one parameter vector known pre-solve): exact
                    # per-sample subtraction, no Gram-identity
                    # cancellation
                    pred = (jnp.einsum(
                        "nrp,p->nr", Y, x_ap,
                        precision=jax.lax.Precision.HIGHEST) + cf)
                    r = (tau - pred) * mask
                    p = pred * mask
                    rp = rp + jnp.sum(r * r, axis=0)
                    pp = pp + jnp.sum(p * p, axis=0)
                    bn = bn + jnp.sum(jnp.sqrt(jnp.sum(r * r, axis=1)))
                    return (G + Gc, g + gc, gcf + gcfc, tsq, tcf, csq,
                            rp, pp, bn, k + 1), (Y, cf, tau)

                Y0 = build_Y(*unpack(stacks[0]))
                P = Y0.shape[-1]
                dt0 = Y0.dtype
                init = (
                    jnp.zeros((rows, P, P), dt0),
                    jnp.zeros((rows, P), dt0),
                    jnp.zeros((rows, P), dt0),
                    jnp.zeros((rows,), dt0),
                    jnp.zeros((rows,), dt0),
                    jnp.zeros((rows,), dt0),
                    jnp.zeros((rows,), dt0),
                    jnp.zeros((rows,), dt0),
                    jnp.zeros((), dt0),
                    jnp.zeros((), jnp.int32),
                )
                ((G, g, gcf, tsq, tcf, csq, rp, pp, bn, _),
                 (Ystack, cf_stack, tau_stack)) = jax.lax.scan(
                    step, init, (stacks, Ws, torqs)
                )
                # OLS std-space aggregates (w2 = 1) in the SAME dispatch
                # (the separate _agg_jit round trip cost ~0.09 s/pass).
                # The base-space projections stay on the HOST in f64: an
                # f32 on-device Pb^T G Pb loses ~0.1 absolute on
                # 1e6-scale Gram entries, which tripled the SDP's Newton
                # work (measured: SDP stage 0.22 -> 0.69 s)
                Gs = jnp.sum(G, axis=0)
                gt = jnp.sum(g, axis=0)
                gc = jnp.sum(gcf, axis=0)
                # the 6 base-wrench columns of the contact series ride
                # along: the host torque write-back needs exactly these
                # (the full series stays lazy)
                cf6 = cf_stack[:, :, :6].reshape(-1, 6)
                # ONE flat host-bound buffer = ONE device->host fetch
                # for everything the host consumes this pass
                packed = jnp.concatenate([
                    Gs.ravel(), gt, gc, tsq, tcf, csq, rp, pp,
                    jnp.reshape(bn, (1,)), cf6.ravel(),
                ])
                return G, g, gcf, Ystack, cf_stack, tau_stack, packed

            def walk_scan_cached(Ys, cfs, torqs, n_valid, x_ap):
                """Same aggregates as walk_scan from the PREVIOUS pass's
                device-resident Y and contact chunks: repeat identifies
                of byte-identical kinematics + wrenches (bench warm
                loop, block-selection score+estimate, essential/CAD
                sweeps) skip the regressor build and the contact-frame
                FK — the pass becomes Gram einsums + residual stats."""
                n_chunks, chunk = torqs.shape[0], torqs.shape[1]
                rows = torqs.shape[-1]

                def step(carry, xs):
                    G, g, gcf, tsq, tcf, csq, rp, pp, bn, k = carry
                    Y, cf, torq = xs
                    tau = torq
                    if add_cf_base:
                        tau = tau.at[:, :6].add(cf[:, :6])
                    valid = (k * chunk + jnp.arange(chunk)) < n_valid
                    mask = jnp.broadcast_to(
                        valid.astype(tau.dtype)[:, None], tau.shape
                    )
                    Gc, gc, gcfc = gram_from_Y(Y, tau, cf, mask)
                    tsq = tsq + jnp.sum(mask * tau * tau, axis=0)
                    tcf = tcf + jnp.sum(mask * tau * cf, axis=0)
                    csq = csq + jnp.sum(mask * cf * cf, axis=0)
                    pred = (jnp.einsum(
                        "nrp,p->nr", Y, x_ap,
                        precision=jax.lax.Precision.HIGHEST) + cf)
                    r = (tau - pred) * mask
                    p = pred * mask
                    rp = rp + jnp.sum(r * r, axis=0)
                    pp = pp + jnp.sum(p * p, axis=0)
                    bn = bn + jnp.sum(jnp.sqrt(jnp.sum(r * r, axis=1)))
                    return (G + Gc, g + gc, gcf + gcfc, tsq, tcf, csq,
                            rp, pp, bn, k + 1), tau

                P = Ys.shape[-1]
                dt0 = Ys.dtype
                init = (
                    jnp.zeros((rows, P, P), dt0),
                    jnp.zeros((rows, P), dt0),
                    jnp.zeros((rows, P), dt0),
                    jnp.zeros((rows,), dt0),
                    jnp.zeros((rows,), dt0),
                    jnp.zeros((rows,), dt0),
                    jnp.zeros((rows,), dt0),
                    jnp.zeros((rows,), dt0),
                    jnp.zeros((), dt0),
                    jnp.zeros((), jnp.int32),
                )
                ((G, g, gcf, tsq, tcf, csq, rp, pp, bn, _),
                 tau_stack) = jax.lax.scan(step, init, (Ys, cfs, torqs))
                Gs = jnp.sum(G, axis=0)
                gt = jnp.sum(g, axis=0)
                gc = jnp.sum(gcf, axis=0)
                cf6 = cfs[:, :, :6].reshape(-1, 6)
                packed = jnp.concatenate([
                    Gs.ravel(), gt, gc, tsq, tcf, csq, rp, pp,
                    jnp.reshape(bn, (1,)), cf6.ravel(),
                ])
                return G, g, gcf, tau_stack, packed

            self._regr_jit_cache[key] = jax.jit(walk_scan)
            self._regr_jit_cache[key + ("cached",)] = jax.jit(walk_scan_cached)
        fn = self._regr_jit_cache[key]
        dt = self._compute_dtype()
        _t = self._p0()
        sk = (staged["chunk"], staged.get("shards", 0))
        Ws = self._staged_put(
            "wrench", staged["pad"](np.asarray(W, dtype=dt)),
            staged["stackc"], extra_key=sk)
        torqs = self._staged_put(
            "torq", staged["pad"](np.asarray(torq_raw, dtype=dt)),
            staged["stackc"], extra_key=sk)
        x_ap = np.asarray(self.xStdModel[self.identified_params],
                          dtype=float)
        # Y/cf chunk reuse across byte-identical passes: the staging
        # memo fingerprint pins the kinematic state, the wrench staging
        # fingerprint pins W, and `key` pins the compiled layout. Torques
        # stay an argument (they differ across sim/measured passes).
        memo = getattr(self, "_staged_memo", None)
        wfp = (memo[0] if memo is not None else None,
               self._put_cache["wrench"][0], key)
        wcache = getattr(self, "_walk_cache", None)
        if (wcache is not None and wfp[0] is not None
                and wcache[0] == wfp):
            Ystack, cf_stack = wcache[1], wcache[2]
            (G, g, gcf, tau_stack, packed) = self._regr_jit_cache[
                key + ("cached",)
            ](Ystack, cf_stack, torqs, jnp.asarray(staged["N"], dt),
              jnp.asarray(x_ap, dt))
        else:
            (G, g, gcf, Ystack, cf_stack, tau_stack, packed) = fn(
                staged["stacks"], Ws, torqs, jnp.asarray(staged["N"], dt),
                jnp.asarray(x_ap, dt),
            )
            if wfp[0] is not None:
                self._walk_cache = (wfp, Ystack, cf_stack)
        flat = np.asarray(packed, dtype=float)  # the single host fetch
        P = self.num_identified_params
        rows = self.num_dofs + self.fb
        o = 0

        def take(n, shape=None):
            nonlocal o
            a = flat[o:o + n]
            o += n
            return a if shape is None else a.reshape(shape)

        host = dict(
            G_std=take(P * P, (P, P)),
            g_tau=take(P),
            g_cf=take(P),
            tau_sq_rows=take(rows),
            tau_cf_rows=take(rows),
            cf_sq_rows=take(rows),
            ap_rp=take(rows),
            ap_pp=take(rows),
            ap_bn=float(take(1)[0]),
            ap_x=x_ap,
            cf6=take(flat.size - o, (-1, 6)),
        )
        self._pmark("walk_gram_fused", _t)
        return G, g, gcf, Ystack, cf_stack, tau_stack, host

    def _stream_inputs(self, samples, idx, Q, V, A, BR, BV, BA):
        from .utils import helpers as H

        nd = self.num_dofs
        sign = H.get_friction_sign_series(samples, self.opt)[idx, :nd]
        vsig = H.get_friction_sign_velocities(samples, self.opt)[idx, :nd]
        return sign, vsig

    def _stage_streaming(self, samples, idx, N, rows, Q, V, A, BR, BV, BA):
        """Stage the per-sample state ONCE per dataset as (n_chunks,
        chunk, ...) device stacks. The sim pass, the Gram scan and every
        reporting contraction reuse the same staged inputs instead of
        three host->device passes over ~11 MB of state.
        Invalidated at the top of computeRegressors."""
        st = getattr(self, "_staged", None)
        if st is not None and st["N"] == N:
            return st
        import jax.numpy as jnp

        opt = self.opt
        dt = self._compute_dtype()
        sign, vsig = self._stream_inputs(samples, idx, Q, V, A, BR, BV, BA)

        chunk = int(opt.get("gramChunk", 4096))
        # staging memo: the padded host copies + packed state + device
        # stacks are a pure function of the input series and the chunk
        # geometry. Re-identifying the same bytes (bench warm loop,
        # block-selection score+estimate, essential-params passes, CAD
        # sweeps) pays only a ~15 ms fingerprint instead of ~150 ms of
        # host packing. Entries derived from the TORQUE series
        # (taum/cfm stacks) are dropped on reuse — torques are not part
        # of this key and the fused/residual paths rebuild them per pass.
        # blake2b, not crc32: a 32-bit collision between two same-shaped
        # datasets would silently identify against stale device buffers.
        import hashlib

        def _fp(a):
            if a is None:
                return None
            b = np.ascontiguousarray(a)
            return (b.shape, str(b.dtype),
                    hashlib.blake2b(b, digest_size=16).digest())

        fp = (N, rows, chunk, int(opt.get("shardSamples", 0) or 0),
              str(dt), tuple(_fp(a) for a in (Q, V, A, BR, BV, BA, sign, vsig)))
        memo = getattr(self, "_staged_memo", None)
        if memo is not None and memo[0] == fp:
            st = dict(memo[1])
            st.pop("taum_stack", None)
            st.pop("cfm_stack", None)
            self._staged = st
            return st
        # multi-chip SPMD (SURVEY §2.9): shard the sample axis of each
        # chunk over a device mesh — the jitted Gram contraction is
        # already a sample-axis reduction, so XLA partitions it and
        # inserts the cross-device psum; the (rows, P, P) output
        # replicates.
        shards = int(opt.get("shardSamples", 0) or 0)
        shard_spec = None
        if shards > 1:
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as PS

            from .parallel.mesh import make_mesh

            mesh = make_mesh(shards)
            chunk = ((chunk + shards - 1) // shards) * shards

            def shard_spec(a, sample_axis=0):
                axes = [None] * a.ndim
                axes[sample_axis] = "samples"
                return NamedSharding(mesh, PS(*axes))

        def pad(a):
            r = (-len(a)) % chunk
            if r == 0:
                return a
            return np.concatenate([a, np.zeros((r,) + a.shape[1:], a.dtype)], axis=0)

        def to_dev(a, sample_axis=0):
            aj = jnp.asarray(a, dt)
            if shard_spec is not None:
                import jax as _jax

                aj = _jax.device_put(aj, shard_spec(aj, sample_axis))
            return aj

        _t = self._p0()
        n_pad = ((N + chunk - 1) // chunk) * chunk
        n_chunks = n_pad // chunk
        host = [pad(np.asarray(a)) if a is not None else None
                for a in (Q, V, A, BR, BV, BA, sign, vsig)]

        def stackc(a):
            return to_dev(a.reshape((n_chunks, chunk) + a.shape[1:]),
                          sample_axis=1)

        # PACK the per-sample state into ONE (n_chunks, chunk, C) array:
        # a single host->device transfer instead of seven, the sign
        # series derived on device from vsig, and vsig itself dropped
        # when it aliases the pipeline velocities (no separately
        # filtered sign velocities) — together ~40% of the staging
        # bytes and 6 transfers saved per pass
        vsig_same = bool(np.array_equal(vsig, V))
        flat = [np.asarray(Q), np.asarray(V), np.asarray(A)]
        if BR is not None:
            flat += [np.asarray(BR).reshape(len(BR), 9),
                     np.asarray(BV), np.asarray(BA)]
        if not vsig_same:
            flat.append(np.asarray(vsig))
        # pack in the compute dtype on the host: halves the transferred
        # bytes vs shipping f64, and lets the staging cache fingerprint the
        # exact bytes that reach the device
        packed = pad(np.ascontiguousarray(
            np.concatenate(flat, axis=1).astype(dt)))
        stacks = None
        if n_chunks <= 64:
            stacks = self._staged_put(
                "state", packed, stackc, extra_key=(chunk, shards))
        self._pmark("stage_transfer", _t, sync=stacks)
        st = dict(N=N, rows=rows, chunk=chunk, n_pad=n_pad,
                  n_chunks=n_chunks, host=host, stacks=stacks,
                  stackc=stackc, to_dev=to_dev, pad=pad, shards=shards,
                  sign=sign, vsig=vsig, vsig_same=vsig_same)
        self._staged = st
        self._staged_memo = (fp, dict(st))
        return st

    def _ensure_ystack(self, staged):
        """Build (once) and return the device-resident regressor chunk
        stack for this staged dataset, or None when disabled/oversized
        (auto gate: Y <= 2 GB) or on the long-recording fallback path.
        One batched-RNEA build then serves the a-priori sim contraction,
        the Gram accumulation, the WLS residual and the reporting
        contractions of the pass."""
        if staged.get("Ystack") is not None or staged.get("ycache_off"):
            return staged.get("Ystack")
        if staged["stacks"] is None:
            staged["ycache_off"] = True
            return None
        opt = self.opt
        cache_y = int(opt.get("cacheRegressorDevice", -1))
        if cache_y < 0:
            dt = self._compute_dtype()
            y_bytes = (staged["n_pad"] * staged["rows"]
                       * self.num_identified_params * np.dtype(dt).itemsize)
            cache_y = int(y_bytes <= (2 << 30))
        if not cache_y:
            staged["ycache_off"] = True
            return None
        _t = self._p0()
        fns = self._streaming_fns(bool(opt["floatingBase"]),
                                  staged["vsig_same"])
        staged["Ystack"] = fns["build_scan"](staged["stacks"])
        self._pmark("ystack_build", _t, sync=staged["Ystack"])
        return staged["Ystack"]

    def _scan_contract(self, staged, xs) -> np.ndarray:
        """(K, N, rows) torque contractions tau_hat = Y @ x_k over the
        staged chunks — one dispatch on the scan path."""
        import jax.numpy as jnp

        opt = self.opt
        fns = self._streaming_fns(bool(opt["floatingBase"]),
                                  staged["vsig_same"])
        dt = self._compute_dtype()
        N, rows = staged["N"], staged["rows"]
        K = len(xs)
        xj = jnp.asarray(np.stack(xs), dt)
        Yst = self._ensure_ystack(staged)
        if Yst is not None:
            _t = self._p0()
            outs = np.asarray(fns["contract_cached"](Yst, xj),
                              dtype=float)  # (K, n_chunks, chunk, rows)
            self._pmark("contract", _t)
            return outs.reshape(K, staged["n_pad"], rows)[:, :N]
        if staged["stacks"] is not None:
            outs = np.asarray(fns["contract_scan"](staged["stacks"], xj),
                              dtype=float)  # (n_chunks, K, chunk, rows)
            return outs.transpose(1, 0, 2, 3).reshape(
                K, staged["n_pad"], rows)[:, :N]
        # long-recording fallback: per-chunk dispatches (host index 6,
        # the sign series, is derived on device from vsig)
        out = np.zeros((K, N, rows))
        chunk = staged["chunk"]
        for s0 in range(0, staged["n_pad"], chunk):
            sl = slice(s0, s0 + chunk)
            args = [jnp.asarray(a[sl], dt) if a is not None else None
                    for i, a in enumerate(staged["host"]) if i != 6]
            res = np.asarray(fns["contract"](*args, xj), dtype=float)
            hi = min(s0 + chunk, N)
            if s0 < N:
                out[:, s0:hi] = res[:, : hi - s0]
        return out

    def _compute_streaming(self, samples, idx, N, rows, Q, V, A, BR, BV, BA):
        import jax.numpy as jnp

        opt = self.opt
        if opt["filterRegressor"]:
            raise ValueError(
                "materializeRegressor=0 cannot filter regressor columns "
                "(filterRegressor needs the stacked regressor); essential/"
                "std_direct/OLS/WLS/SDP all run from the accumulated Grams"
            )
        dt = self._compute_dtype()
        floating = bool(opt["floatingBase"])
        staged = self._stage_streaming(samples, idx, N, rows, Q, V, A, BR, BV, BA)
        fns = self._streaming_fns(floating, staged["vsig_same"])
        chunk, n_pad, n_chunks = staged["chunk"], staged["n_pad"], staged["n_chunks"]
        pad, to_dev, stackc = staged["pad"], staged["to_dev"], staged["stackc"]

        P = self.num_identified_params
        if getattr(self, "_walk_fused", None) is not None:
            # the fused walking-contact dispatch already accumulated the
            # per-channel Grams (and left Y/cf/tau chunks device-resident)
            # AND the w2=1 OLS aggregates AND the a-priori residual stats
            # — all fetched in its single packed round trip. Populate the
            # aggregate + residual caches directly instead of
            # re-dispatching _agg_jit / resid_scan
            G, g, gcf, fhost = self._walk_fused
            self._walk_fused = None
            self.YStd = None
            self.YBase = None
            self.G_rows, self.g_rows, self.gcf_rows = G, g, gcf
            self.tau_sq_rows = fhost["tau_sq_rows"]
            self.tau_cf_rows = fhost["tau_cf_rows"]
            self.cf_sq_rows = fhost["cf_sq_rows"]
            self.G_std = fhost["G_std"]
            self.g_tau = fhost["g_tau"]
            self.g_cf = fhost["g_cf"]
            # seed the residual-stats cache: the reporting pass's urdf
            # leg (estimateRegressorTorques("urdf")) is served without a
            # further dispatch
            self._resid_cache[fhost["ap_x"].tobytes()] = dict(
                rp=fhost["ap_rp"], pp=fhost["ap_pp"],
                tp=fhost["tau_sq_rows"], bn=fhost["ap_bn"],
            )
            # base projection in host f64 (precision-critical for the
            # downstream Cholesky/SDP; see walk_scan comment)
            Pb = self.B if opt["useBasisProjection"] else self.Pb
            self.G_base = Pb.T @ self.G_std @ Pb
            self.g_base = Pb.T @ self.g_tau
            self.g_cf_base = Pb.T @ self.g_cf
            self.tau_sq = float(self.tau_sq_rows.sum())
            self.tau_cf = float(self.tau_cf_rows.sum())
            self.cf_sq = float(self.cf_sq_rows.sum())
            if not opt["useStructuralRegressor"]:
                # data-derived QR changes the base projection — the
                # fused base-space aggregates are stale; recompute them
                # (and do NOT seed the cache with the stale tuple)
                self.computeRegressorLinDepsQR(self.G_std)
                self._set_streaming_aggregates(np.ones(rows))
                return
            cache = self._agg_cache
            cache[np.ones(rows).tobytes()] = (
                self.G_std, self.g_tau, self.g_cf, self.tau_sq,
                self.tau_cf, self.cf_sq, self.G_base, self.g_base,
                self.g_cf_base,
            )
            return
        tau2d = self.tau.reshape(N, rows)
        cf2d = self.contactForcesSum.reshape(N, rows)
        if staged["stacks"] is not None:
            # one dispatch for ALL chunks: lax.scan-accumulate on device.
            # The per-channel Grams stay DEVICE-RESIDENT: only the small
            # (P,P)/(P,) aggregates reach the host (in
            # _set_streaming_aggregates), not the (rows,P,P) tensor
            # (~20 MB at 30 DOF).
            # with the regressor chunks cached on device (auto when Y
            # <= 2 GB) the Gram accumulation is einsum-only; all dispatch
            # paths of the pass share that one batched-RNEA build
            Yst = self._ensure_ystack(staged)
            _t = self._p0()
            if Yst is not None:
                G, g, gcf = fns["gram_scan_cached"](
                    Yst,
                    stackc(pad(tau2d)),
                    stackc(pad(cf2d)),
                    jnp.asarray(N, dt),
                )
            else:
                G, g, gcf = fns["gram_scan"](
                    staged["stacks"],
                    stackc(pad(tau2d)),
                    stackc(pad(cf2d)),
                    jnp.asarray(N, dt),
                )
            self._pmark("gram_scan", _t, sync=(G, g, gcf))
        else:
            # very long recordings: accumulate on host in f64 (an f32
            # carry over hundreds of chunks would lose Gram precision)
            G = np.zeros((rows, P, P))
            g = np.zeros((rows, P))
            gcf = np.zeros((rows, P))
            maskN = pad(np.ones((N, rows)))
            # host index 6 (sign) is derived on device from vsig
            arrays = [a for i, a in enumerate(staged["host"]) if i != 6]
            arrays += [pad(tau2d), pad(cf2d)]
            for s0 in range(0, n_pad, chunk):
                sl = slice(s0, s0 + chunk)
                args = [
                    to_dev(a[sl]) if a is not None else None for a in arrays
                ]
                Gc, gc, gcfc = fns["gram_chunk"](*args[:7], args[7], args[8],
                                                 to_dev(maskN[sl]))
                G += np.asarray(Gc, dtype=float)
                g += np.asarray(gc, dtype=float)
                gcf += np.asarray(gcfc, dtype=float)

        self.YStd = None
        self.YBase = None
        # per-channel quantities (for WLS reweighting) + aggregates
        self.G_rows, self.g_rows, self.gcf_rows = G, g, gcf
        self.tau_sq_rows = (tau2d**2).sum(axis=0)
        self.tau_cf_rows = (tau2d * cf2d).sum(axis=0)
        self.cf_sq_rows = (cf2d**2).sum(axis=0)
        self._set_streaming_aggregates(np.ones(rows))

        if not opt["useStructuralRegressor"]:
            # the Gram shares the regressor's column dependencies
            self.computeRegressorLinDepsQR(self.G_std)
            self._set_streaming_aggregates(np.ones(rows))

    def _set_streaming_aggregates(self, w2) -> None:
        """Aggregate the per-channel Grams with channel weights² `w2`
        (w2=1: plain OLS aggregation; WLS rescales every equation row of
        channel r by w_r, which multiplies its Gram contribution by
        w_r²). Refreshes both std- and base-space quantities."""
        opt = self.opt
        w2 = np.asarray(w2, dtype=float)
        _t = self._p0()
        # WLS re-aggregates twice per solve (weights, then restore to
        # ones) — memoize the aggregates per weight vector (tiny: two
        # (P,P)/(P,) sets per dataset)
        key = w2.tobytes()
        cache = getattr(self, "_agg_cache", None)
        if cache is None:
            cache = self._agg_cache = {}
        if key in cache:
            (self.G_std, self.g_tau, self.g_cf, self.tau_sq, self.tau_cf,
             self.cf_sq, self.G_base, self.g_base, self.g_cf_base) = cache[key]
            return
        if not isinstance(self.G_rows, np.ndarray):
            # device-resident per-channel Grams (streaming fast path):
            # contract on device, fetch only the (P,P)/(P,) aggregates
            import jax
            import jax.numpy as jnp

            if not hasattr(Model, "_agg_jit"):
                Model._agg_jit = jax.jit(
                    lambda w, G, g, gc: (
                        jnp.einsum("r,rpq->pq", w, G),
                        w @ g,
                        w @ gc,
                    )
                )
            Gs, gt, gc = Model._agg_jit(
                jnp.asarray(w2, self.G_rows.dtype),
                self.G_rows, self.g_rows, self.gcf_rows,
            )
            self.G_std = np.asarray(Gs, dtype=float)
            self.g_tau = np.asarray(gt, dtype=float)
            self.g_cf = np.asarray(gc, dtype=float)
        else:
            self.G_std = np.einsum("r,rpq->pq", w2, self.G_rows)
            self.g_tau = w2 @ self.g_rows
            self.g_cf = w2 @ self.gcf_rows
        self.tau_sq = float(w2 @ self.tau_sq_rows)
        self.tau_cf = float(w2 @ self.tau_cf_rows)
        self.cf_sq = float(w2 @ self.cf_sq_rows)
        Pb = self.B if opt["useBasisProjection"] else self.Pb
        self.G_base = Pb.T @ self.G_std @ Pb
        self.g_base = Pb.T @ self.g_tau
        self.g_cf_base = Pb.T @ self.g_cf
        cache[key] = (self.G_std, self.g_tau, self.g_cf, self.tau_sq,
                      self.tau_cf, self.cf_sq, self.G_base, self.g_base,
                      self.g_cf_base)
        self._pmark("aggregates", _t)


    def contract_identified(self, x_identified) -> np.ndarray:
        """tau_hat = Y @ x recomputed on device in chunks (streaming mode,
        where YStd is never materialized). Returns (N, rows). Cached per
        parameter vector until the next computeRegressors — the
        reporting path asks for the same contraction repeatedly."""
        x = np.asarray(x_identified, dtype=float)
        key = x.tobytes()
        cache = getattr(self, "_contract_cache", None)
        if cache is None:
            cache = self._contract_cache = {}
        if key not in cache:
            res = self.contract_identified_multi([x])[0]
            cache[key] = res
        return cache[key]

    def residual_stats(self, xs):
        """Device-computed residual statistics for K parameter vectors
        against the measured torques (+ contact correction): list of
        dicts {rp (rows,), pp (rows,), tp (rows,), bn scalar} — see
        resid_scan. Returns None when the cached regressor stack is not
        available (caller falls back to materializing tau_hat). Cached
        per parameter vector until the next computeRegressors."""
        staged = getattr(self, "_staged", None)
        if staged is None or staged["N"] != self.data.num_used_samples:
            return None
        Yst = self._ensure_ystack(staged)
        if Yst is None:
            return None
        import jax.numpy as jnp

        xs = [np.asarray(x, dtype=float) for x in xs]
        cache = getattr(self, "_resid_cache", None)
        if cache is None:
            cache = self._resid_cache = {}
        missing = [x for x in xs if x.tobytes() not in cache]
        if missing:
            opt = self.opt
            dt = self._compute_dtype()
            N, rows = staged["N"], staged["rows"]
            if "taum_stack" not in staged:
                taum = np.asarray(self.tauMeasured, dtype=float)
                cf2d = self.contactForcesSum.reshape(N, rows)
                staged["taum_stack"] = staged["stackc"](staged["pad"](taum))
                staged["cfm_stack"] = staged["stackc"](staged["pad"](cf2d))
            fns = self._streaming_fns(bool(opt["floatingBase"]),
                                      staged["vsig_same"])
            _t = self._p0()
            xj = jnp.asarray(np.stack(missing), dt)
            packed = fns["resid_scan"](
                Yst, xj, staged["taum_stack"], staged["cfm_stack"],
                jnp.asarray(N, dt),
            )
            flat = np.asarray(packed, dtype=float)  # single host fetch
            self._pmark("residual_stats", _t)
            K = len(missing)
            rp = flat[: K * rows].reshape(K, rows)
            pp = flat[K * rows : 2 * K * rows].reshape(K, rows)
            tp = flat[2 * K * rows : 2 * K * rows + rows]
            bn = flat[2 * K * rows + rows :]
            for i, x in enumerate(missing):
                cache[x.tobytes()] = dict(
                    rp=rp[i], pp=pp[i], tp=tp, bn=float(bn[i])
                )
        return [cache[x.tobytes()] for x in xs]

    def prefetch_contractions(self, xs) -> None:
        """Compute several contractions in ONE pass over the data (the
        Y build dominates; reporting needs urdf + identified torques)."""
        xs = [np.asarray(x, dtype=float) for x in xs]
        cache = getattr(self, "_contract_cache", None)
        if cache is None:
            cache = self._contract_cache = {}
        missing = [x for x in xs if x.tobytes() not in cache]
        if not missing:
            return
        res = self.contract_identified_multi(missing)
        for x, r in zip(missing, res):
            cache[x.tobytes()] = r

    def contract_identified_multi(self, xs) -> np.ndarray:
        """(K, N, rows) torque contractions for K parameter vectors —
        one scan dispatch over the staged per-dataset device inputs."""
        opt = self.opt
        data = self.data
        N = data.num_used_samples
        rows = self.num_dofs + self.fb
        staged = getattr(self, "_staged", None)
        if staged is None or staged["N"] != N:
            skip = int(opt["skipSamples"])
            idx = np.arange(N) * (skip + 1)
            samples = data.samples
            Q, V, A, BR, BV, BA = self._gather_state(samples, idx)
            staged = self._stage_streaming(
                samples, idx, N, rows, Q, V, A, BR, BV, BA
            )
        return self._scan_contract(staged, xs)

    def _contact_torques(self, link_index: int, Q: np.ndarray, BR, w: np.ndarray):
        """Generalized torque contribution J^T w of a contact wrench
        series, contracted on device in fixed-size padded chunks.
        Returns (N, 6+nd) (reference model.py:535-555)."""
        eng = self.engine
        key = ("contactTau", link_index, BR is not None)
        if key not in self._regr_jit_cache:
            if BR is None:
                self._regr_jit_cache[key] = jax.jit(
                    jax.vmap(
                        lambda q, wc: eng.frame_jacobian(link_index, q).T @ wc
                    )
                )
            else:
                self._regr_jit_cache[key] = jax.jit(
                    jax.vmap(
                        lambda q, br, wc: eng.frame_jacobian(link_index, q, br).T
                        @ wc
                    )
                )
        fn = self._regr_jit_cache[key]
        arrays = [Q, w] if BR is None else [Q, BR, w]
        return self._chunked_apply(fn, arrays, len(Q))

    def _chunked_apply(self, fn, arrays, N: int) -> np.ndarray:
        """Apply a jitted per-chunk fn over the sample axis of `arrays`
        in FIXED-SIZE padded chunks (pad by repeating the last row): one
        compiled shape serves every dataset length — a recording N baked
        into the jit shape costs a fresh multi-minute compile.
        Returns the stacked (N, ...) result."""
        dt = self._compute_dtype()
        chunk = min(int(self.opt.get("gramChunk", 4096)), max(N, 16))
        parts = []
        for s0 in range(0, N, chunk):
            sl = slice(s0, s0 + chunk)
            n_here = min(chunk, N - s0)
            padn = chunk - n_here
            args = []
            for a in arrays:
                a = np.asarray(a[sl])
                if padn:
                    a = np.concatenate([a, np.repeat(a[-1:], padn, axis=0)])
                args.append(jnp.asarray(a, dtype=dt))
            parts.append(np.asarray(fn(*args), dtype=float)[:n_here])
        return np.concatenate(parts)

    def _contact_torques_sum_staged(self, link_indices, staged, W):
        """Sum_f J_f^T w_f over ALL contact frames in ONE dispatch from
        the staged device chunks (the per-frame chunked path re-stages
        Q/BR from the host for every frame). W: (N, F, 6) host.
        Returns (N, 6+nd) (reference model.py:535-555)."""
        import jax.numpy as jnp

        eng = self.engine
        floating = bool(self.opt["floatingBase"])
        unpack = self._streaming_fns(floating, staged["vsig_same"])["unpack_raw"]
        key = ("contactSumScan", tuple(link_indices), floating,
               staged["vsig_same"])
        if key not in self._regr_jit_cache:

            def per_sample(q, br, w):
                out = jnp.zeros(6 + self.num_dofs, dtype=q.dtype)
                for f, li in enumerate(link_indices):
                    J = (eng.frame_jacobian(li, q, br) if floating
                         else eng.frame_jacobian(li, q))
                    out = out + J.T @ w[f]
                return out

            def scan_fn(stacks, Ws):
                def step(carry, xs):
                    st, w = xs
                    a = unpack(st)
                    q, br = a[0], a[3]
                    if floating:
                        return carry, jax.vmap(per_sample)(q, br, w)
                    return carry, jax.vmap(
                        lambda qq, ww: per_sample(qq, None, ww)
                    )(q, w)

                _, out = jax.lax.scan(step, 0, (stacks, Ws))
                return out

            self._regr_jit_cache[key] = jax.jit(scan_fn)
        fn = self._regr_jit_cache[key]
        # (N, F, 6) -> (n_chunks, chunk, F, 6) on device; frame axis
        # stays dense so every frame shares the one FK per sample
        Ws = staged["stackc"](staged["pad"](np.asarray(W, dtype=float)))
        out = fn(staged["stacks"], Ws)
        return np.asarray(out, dtype=float).reshape(
            staged["n_pad"], 6 + self.num_dofs
        )[: staged["N"]]

    def _contact_jacobians(self, link_index: int, Q: np.ndarray, BR):
        """Batched frame Jacobians, transposed: (N, 6+nd, 6) J^T rows.
        Fixed-size padded chunks (like simulate_dynamics): one compiled
        shape serves every dataset length — a walking-log N baked into
        the jit shape costs a fresh multi-minute compile."""
        eng = self.engine
        key = ("contactJ", link_index, BR is not None)
        if key not in self._regr_jit_cache:
            if BR is None:
                self._regr_jit_cache[key] = jax.jit(
                    jax.vmap(lambda q: eng.frame_jacobian(link_index, q))
                )
            else:
                self._regr_jit_cache[key] = jax.jit(
                    jax.vmap(lambda q, br: eng.frame_jacobian(link_index, q, br))
                )
        fn = self._regr_jit_cache[key]
        J = self._chunked_apply(fn, [Q] if BR is None else [Q, BR], len(Q))
        return np.swapaxes(J, 1, 2)  # (N, 6, 6+nd) -> J^T rows

    # ------------------------------------------------------------------
    # structural (random) regressor + QR base projection
    # ------------------------------------------------------------------
    def getRandomRegressor(self, n_samples: int | None = None):
        """Structural Gram Y^T Y over random states within URDF limits,
        cached to <urdf>.regressor.npz with the reference's key layout
        (reference model.py:634-830)."""
        opt = self.opt
        suffix = ".gravity_regressor.npz" if opt["identifyGravityParamsOnly"] else ".regressor.npz"
        regr_filename = self.urdf_file + suffix
        fb = int(bool(opt["floatingBase"]))
        if not n_samples:
            n_samples = self.num_dofs * 1000

        def _matches(f) -> bool:
            return (
                int(f["n"]) == n_samples
                and int(f["fb"]) == fb
                and f["R"].shape[0] == self.num_identified_params
                and bool(f["grav_only"]) == bool(opt["identifyGravityParamsOnly"])
                and bool(f["fric"]) == bool(opt["identifyFrictionSimultaneously"])
                and bool(f["fric_sym"]) == bool(opt["identifySymmetricVelFriction"])
            )

        # Canonical file keeps the reference npz layout. When options
        # differ (e.g. a test asks for a small randomSamples on a shared
        # URDF) the result goes to an options-keyed sidecar instead, so
        # the canonical cache is never clobbered and runs with the
        # default options never pay a recompute.
        sidecar = "%s.n%d_fb%d_g%d_f%d_s%d%s" % (
            self.urdf_file,
            n_samples,
            fb,
            int(bool(opt["identifyGravityParamsOnly"])),
            int(bool(opt["identifyFrictionSimultaneously"])),
            int(bool(opt["identifySymmetricVelFriction"])),
            suffix,
        )
        canonical_taken = False
        for path in (regr_filename, sidecar):
            try:
                f = np.load(path)
                if _matches(f):
                    # The rank threshold must reflect the noise floor of
                    # the Gram AS STORED, not the current compute dtype:
                    # an f32-accumulated cache read by an f64 run carries
                    # an O(eps_f32 * maxdiag) floor that reads as ~100
                    # spurious base directions under the f64 threshold
                    # (measured: rank 412 instead of 310 on humanoid30).
                    # Caches written before the dtype was recorded are
                    # assumed f32 (the conservative floor).
                    # scoped to the STRUCTURAL QR only: overwriting the
                    # session _gram_dtype here would apply the cached
                    # file's eps to later DATA-Gram QRs accumulated in
                    # the session dtype (f64 cache + f32 session =
                    # spurious-rank failure all over again)
                    gdt = str(f["gdt"]) if "gdt" in f.files else "float32"
                    self._structural_gram_dtype = (
                        np.float64 if "64" in gdt else np.float32)
                    return f["R"], f["Q"], f["RQ"], f["PQ"]
                if path == regr_filename:
                    canonical_taken = True
            except (OSError, KeyError, ValueError):
                pass

        R = self._random_gram(n_samples)
        self._structural_gram_dtype = self._gram_dtype
        Q, RQ, PQ = sla.qr(R, pivoting=True, mode="economic")
        try:
            np.savez(
                sidecar if canonical_taken else regr_filename,
                R=R,
                Q=Q,
                RQ=RQ,
                PQ=PQ,
                n=n_samples,
                fb=fb,
                grav_only=opt["identifyGravityParamsOnly"],
                fric=opt["identifyFrictionSimultaneously"],
                fric_sym=opt["identifySymmetricVelFriction"],
                gdt=np.dtype(self._gram_dtype).name,
            )
        except OSError:
            pass  # read-only model dir: recompute next time
        return R, Q, RQ, PQ

    def _random_gram(self, n_samples: int) -> np.ndarray:
        """Accumulate the structural Gram on device, vmapped over random
        states (no per-sample Python; reference model.py:690-806)."""
        opt = self.opt
        nd = self.num_dofs
        eng = self.engine
        dt = self._compute_dtype()
        grav_only = bool(opt["identifyGravityParamsOnly"])
        fric = bool(opt["identifyFrictionSimultaneously"])
        floating = bool(opt["floatingBase"])

        jn = self.jointNames
        if self.limits:
            lo = np.array([self.limits[j]["lower"] for j in jn])
            hi = np.array([self.limits[j]["upper"] for j in jn])
            vl = np.array([self.limits[j]["velocity"] for j in jn])
            lo = np.where(np.isfinite(lo), lo, -np.pi)
            hi = np.where(np.isfinite(hi), hi, np.pi)
            vl = np.where(np.isfinite(vl), vl, np.pi)
        else:
            lo, hi, vl = -np.pi * np.ones(nd), np.pi * np.ones(nd), np.pi * np.ones(nd)

        keep = None
        if grav_only:
            keep = np.array(
                [p for p in range(self.num_model_params) if p not in set(self.inertia_params)]
            )
        sign_thresh = float(opt.get("frictionSignThreshold", 0.02))
        stribeck = float(opt.get("stribeckVelocity", 0) or 0)
        sym = bool(opt["identifySymmetricVelFriction"])

        def sample_gram(key):
            ks = jax.random.split(key, 6)
            q = jnp.asarray(lo, dt) + jnp.asarray(hi - lo, dt) * jax.random.uniform(ks[0], (nd,), dtype=dt)
            if grav_only:
                dq = jnp.zeros(nd, dt)
                ddq = jnp.zeros(nd, dt)
            else:
                dq = (jax.random.uniform(ks[1], (nd,), dtype=dt) - 0.5) * 2 * jnp.asarray(vl, dt)
                ddq = (jax.random.uniform(ks[2], (nd,), dtype=dt) - 0.5) * 2 * jnp.pi
            if floating:
                bv = jnp.pi * jax.random.uniform(ks[3], (6,), dtype=dt)
                ba = jnp.pi * jax.random.uniform(ks[4], (6,), dtype=dt)
                if grav_only:
                    bv = jnp.zeros(6, dt)
                    ba = jnp.zeros(6, dt)
                rpy = jax.random.uniform(ks[5], (3,), dtype=dt) * 0.1
                br = rpy_to_base_rot(rpy)
                Y = eng.regressor(q, dq, ddq, br, bv, ba)
            else:
                Y = eng.regressor(q, dq, ddq)
            if keep is not None:
                Y = Y[:, keep]
            if fric:
                fbr = 6 if floating else 0
                blocks = [jnp.diag(jnp.tanh(dq / sign_thresh))]
                if not grav_only:
                    if sym:
                        blocks.append(jnp.diag(dq))
                    else:
                        blocks.append(jnp.diag(jnp.where(dq > 0, dq, 0.0)))
                        blocks.append(jnp.diag(jnp.where(dq < 0, dq, 0.0)))
                    blocks.append(jnp.eye(nd, dtype=dt))
                    if stribeck > 0:
                        blocks.append(
                            jnp.diag(jnp.exp(-jnp.abs(dq) / stribeck) * jnp.sign(dq))
                        )
                F = jnp.concatenate(blocks, axis=1)
                F = jnp.concatenate([jnp.zeros((fbr, F.shape[1]), dt), F], axis=0)
                Y = jnp.concatenate([Y, F], axis=1)
            return Y

        chunk = int(self.opt.get("gramChunk", 4096))

        def chunk_gram(keys):
            Ys = jax.vmap(sample_gram)(keys)  # (C, rows, P)
            P = Ys.shape[-1]
            Yf = Ys.reshape(-1, P)
            return jnp.einsum("rp,rq->pq", Yf, Yf, precision=jax.lax.Precision.HIGHEST)

        shards = int(opt.get("shardSamples", 0) or 0)
        if shards > 1:
            # the cold-start hot loop (n_dofs*1000 random samples,
            # SURVEY §3.1) sharded over the mesh: each device draws its
            # slice of the chunk's keys and accumulates a partial Gram,
            # then a psum — the SAME keys as the single-device path,
            # so the result is bit-identical up to sum reassociation
            from jax.sharding import PartitionSpec as _P

            from .parallel.mesh import make_mesh

            mesh = make_mesh(shards)
            chunk = (-(-chunk // shards)) * shards

            def local(keys):
                return jax.lax.psum(chunk_gram(keys), "samples")

            gram_chunk = jax.jit(jax.shard_map(
                local, mesh=mesh,
                in_specs=(_P("samples"),), out_specs=_P(),
            ))
        else:
            gram_chunk = jax.jit(chunk_gram)

        G = np.zeros((self.num_identified_params, self.num_identified_params))
        key = jax.random.PRNGKey(0)
        done = 0
        while done < n_samples:
            c = min(chunk, n_samples - done)
            key, sub = jax.random.split(key)
            keys = jax.random.split(sub, chunk)  # fixed shape; extra samples harmless
            if c < chunk:
                G_c = np.asarray(gram_chunk(keys), dtype=float)
                # slight oversampling on the final chunk keeps shapes static;
                # dependencies are unaffected by extra random rows
                G += G_c
                done = n_samples
            else:
                G += np.asarray(gram_chunk(keys), dtype=float)
                done += c
        return G

    def computeRegressorLinDepsQR(self, regressor: np.ndarray | None = None) -> None:
        """Pivoted-QR base-parameter projection (reference model.py:832-1052):
        rank via minTol on the R diagonal, permutation Pb/Pd, dependency
        matrix K = Pb^T + Kd Pd^T (Gautier/Sousa), optional orthonormal
        basis B, non-identifiable parameter set."""
        opt = self.opt
        # Pb/B/K change here — cached base-space Gram aggregates are stale
        self._agg_cache = {}
        if regressor is not None:
            Y = regressor
            self.Q, self.R, self.P = sla.qr(Y, pivoting=True, mode="economic")
            qr_gdt = getattr(self, "_gram_dtype", np.float32)
        else:
            Y, self.Q, self.R, self.P = self.getRandomRegressor(
                n_samples=opt["randomSamples"]
            )
            # a structural cache may be stamped with a different dtype
            # than the session accumulates in — the rank threshold must
            # track the precision of the Gram AS DECOMPOSED HERE
            qr_gdt = getattr(self, "_structural_gram_dtype",
                             getattr(self, "_gram_dtype", np.float32))

        # Rank threshold: the reference uses the absolute minTol (1e-4 by
        # default), valid for its f64 Gram whose noise floor is ~1e-10 x
        # scale. On the device the Gram is accumulated in f32, putting
        # the noise floor at ~1e-7 x scale (>> 1e-4 for typical 1e6-scale
        # Grams), so
        # the cut must also be relative to the spectrum scale or noise
        # directions inflate the base parameter count (measured: rank 59
        # instead of 43 on the 7-DOF example, 6% base-param error).
        minTol = float(opt["minTol"])
        diag = np.abs(np.diag(self.R))
        eps = np.finfo(qr_gdt).eps
        tol = max(minTol, 100.0 * eps * float(diag.max(initial=0.0)))
        r = int(np.sum(diag > tol))
        self.num_base_params = r
        self.num_base_inertial_params = r - self.num_dofs

        P = self.P
        nP = P.size
        Pp = np.zeros((nP, nP))
        for i in P:
            Pp[i, P[i]] = 1
        self.Pp = Pp
        self.Pb = Pp.T[:, :r]
        self.Pd = Pp.T[:, r:]
        self.independent_cols = P[:r]

        R1 = self.R[:r, :r]
        R2 = self.R[:r, r:]
        self.linear_deps = sla.solve_triangular(R1, R2)
        self.linear_deps[np.abs(self.linear_deps) < minTol] = 0
        self.Kd = self.linear_deps
        self.K = self.Pb.T + self.Kd @ self.Pd.T

        if opt["useBasisProjection"]:
            B = np.zeros((self.num_identified_params, r))
            for j in range(self.linear_deps.shape[0]):
                for k in range(r, nP):
                    factor = self.linear_deps[j, k - r]
                    if abs(factor) > minTol:
                        B[P[k], j] = factor
                B[self.independent_cols[j], j] = 1
            if opt["orthogonalizeBasis"]:
                Qb, Rb = np.linalg.qr(B)
                Qb[np.abs(Qb) < minTol] = 0
                S = np.zeros_like(Rb)
                for i in range(Rb.shape[0]):
                    if abs(Rb[i, i]) >= minTol:
                        S[i, i] = np.sign(Rb[i, i])
                self.B = Qb @ S
                self.Binv = self.B.T
            else:
                self.B = B
                self.Binv = np.linalg.pinv(B)

        # non-identifiable params: no (significant) contribution to any
        # base combination. Index space: full param vector.
        contrib = np.any(np.abs(self.K) > minTol, axis=0)  # over identified cols
        ident_mask = np.zeros(self.num_all_params, dtype=bool)
        for ci, p in enumerate(self.identified_params):
            if contrib[ci]:
                ident_mask[p] = True
        self.non_id = [p for p in range(self.num_all_params) if not ident_mask[p]]
        self.identifiable = [p for p in range(self.num_all_params) if ident_mask[p]]

    def base_equations_str(self, tol: float = 1e-6) -> list[str]:
        """Human-readable base parameter combinations (replaces the
        reference's sympy base_deps, model.py:1032-1052)."""
        eqs = []
        for i in range(self.num_base_params):
            terms = []
            for ci in np.nonzero(np.abs(self.K[i]) > tol)[0]:
                coeff = self.K[i, ci]
                # K columns are identified-space: map to the full layout
                # (they differ in gravity-only mode)
                name = self.param_names[self.identified_params[ci]]
                if abs(coeff - 1.0) < 1e-9:
                    terms.append(f"+ {name}")
                elif abs(coeff + 1.0) < 1e-9:
                    terms.append(f"- {name}")
                else:
                    terms.append(f"{coeff:+.4g}*{name}")
            eqs.append(" ".join(terms).lstrip("+ "))
        return eqs

    def structural_identifiability(self, tol: float = 1e-6) -> dict:
        """Structural identifiability triple over the inertial parameters
        (reference documentation/design_notes.md:98-103: the 29-DOF
        suspended walkman has ~70 individually identifiable params, ~213
        base directions and a ~207-direction null space of ~420 params).

        - individually_identifiable: params that appear ALONE in a base
          combination (their value is determined, not just a lumped sum)
        - base_directions: rank of the structural regressor (what any
          amount of excitation can ever determine)
        - null_directions: identified inertial params minus the rank —
          the recoverable-only-with-more-sensors gap
        Friction/offset columns are excluded so the triple is comparable
        to the reference's inertial-only analysis.
        """
        if not hasattr(self, "K"):
            raise ValueError("structural_identifiability needs "
                             "computeRegressorLinDepsQR to have run")
        n_inertial = self.num_model_params  # 10-per-link slots
        inertial_cols = [ci for ci, p in enumerate(self.identified_params)
                         if p < n_inertial]
        inertial_set = set(inertial_cols)
        individual = set()
        inertial_rank = 0
        for row in self.K:
            nz = np.nonzero(np.abs(row) > tol)[0]
            nz_inertial = [c for c in nz if c in inertial_set]
            if not nz_inertial:
                continue  # pure friction/offset direction
            inertial_rank += 1
            if len(nz) == 1:
                individual.add(self.identified_params[nz[0]])
        n_id_inertial = len(inertial_cols)
        return {
            "individually_identifiable": len(individual),
            "individually_identifiable_params": sorted(individual),
            "base_directions": inertial_rank,
            "null_directions": n_id_inertial - inertial_rank,
            "n_inertial_params": n_id_inertial,
        }

    def sensor_placement_study(
        self, sensor_sets: dict, n_samples: int = 2000
    ) -> dict:
        """Structural rank gain from adding 6-axis F/T sensors
        (reference documentation/design_notes.md:104-110: each added
        F/T recovers ~3 of the walkman's ~207 null directions, roughly
        additive for disjoint placements; known payloads do not change
        the rank at all).

        sensor_sets: {name: [link names]} candidate placements. For
        each, the structural Gram of the row-extended regressor
        [Y_std; Y_sensors] is accumulated over random in-limit states
        and the inertial rank compared to the sensor-less baseline.
        Friction columns are excluded — an F/T sensor says nothing
        about joint friction, and the triple stays comparable to
        structural_identifiability()."""
        opt = self.opt
        eng = self.engine
        nd = self.num_dofs
        dt = self._compute_dtype()
        floating = bool(opt["floatingBase"])
        jn = self.jointNames
        if self.limits:
            lo = np.array([self.limits[j]["lower"] for j in jn])
            hi = np.array([self.limits[j]["upper"] for j in jn])
            vl = np.array([self.limits[j]["velocity"] for j in jn])
            lo = np.where(np.isfinite(lo), lo, -np.pi)
            hi = np.where(np.isfinite(hi), hi, np.pi)
            vl = np.where(np.isfinite(vl), vl, np.pi)
        else:
            lo, hi, vl = -np.pi * np.ones(nd), np.pi * np.ones(nd), np.pi * np.ones(nd)

        def gram_for(links: tuple[int, ...]) -> np.ndarray:
            def sample(key):
                ks = jax.random.split(key, 6)
                q = jnp.asarray(lo, dt) + jnp.asarray(hi - lo, dt) * \
                    jax.random.uniform(ks[0], (nd,), dtype=dt)
                dq = (jax.random.uniform(ks[1], (nd,), dtype=dt) - 0.5) * 2 * jnp.asarray(vl, dt)
                ddq = (jax.random.uniform(ks[2], (nd,), dtype=dt) - 0.5) * 2 * jnp.pi
                if floating:
                    bv = jnp.pi * jax.random.uniform(ks[3], (6,), dtype=dt)
                    ba = jnp.pi * jax.random.uniform(ks[4], (6,), dtype=dt)
                    rpy = jax.random.uniform(ks[5], (3,), dtype=dt) * 0.1
                    br = rpy_to_base_rot(rpy)
                    Y = eng.regressor(q, dq, ddq, br, bv, ba)
                    rows = [Y]
                    if links:
                        rows.append(eng.sensor_wrench_regressor(links, q, dq, ddq, br, bv, ba))
                else:
                    Y = eng.regressor(q, dq, ddq)
                    rows = [Y]
                    if links:
                        rows.append(eng.sensor_wrench_regressor(links, q, dq, ddq))
                return jnp.concatenate(rows, axis=0)

            chunk = min(int(self.opt.get("gramChunk", 4096)), n_samples)

            @jax.jit
            def gram_chunk(keys):
                Ys = jax.vmap(sample)(keys)
                P = Ys.shape[-1]
                Yf = Ys.reshape(-1, P)
                return jnp.einsum("rp,rq->pq", Yf, Yf,
                                  precision=jax.lax.Precision.HIGHEST)

            G = np.zeros((self.num_model_params, self.num_model_params))
            key = jax.random.PRNGKey(7)
            done = 0
            while done < n_samples:
                key, sub = jax.random.split(key)
                G += np.asarray(gram_chunk(jax.random.split(sub, chunk)), dtype=float)
                done += chunk
            return G

        def rank_of(G: np.ndarray) -> int:
            _, R, _ = sla.qr(G, pivoting=True, mode="economic")
            diag = np.abs(np.diag(R))
            eps = np.finfo(self._gram_dtype).eps
            tol = max(float(self.opt["minTol"]), 100.0 * eps * float(diag.max(initial=0.0)))
            return int(np.sum(diag > tol))

        name_to_idx = {n: i for i, n in enumerate(self.linkNames)}
        base_rank = rank_of(gram_for(()))
        out = {
            "baseline_rank": base_rank,
            "n_inertial_params": self.num_model_params,
            "null_directions": self.num_model_params - base_rank,
            "sets": {},
        }
        for name, links in sensor_sets.items():
            idx = tuple(sorted(name_to_idx[l] for l in links))
            r = rank_of(gram_for(idx))
            out["sets"][name] = {
                "links": list(links),
                "rank": r,
                "gain": r - base_rank,
            }
        return out

    def getSubregressorsConditionNumbers(self, YBase=None, G=None) -> list[float]:
        """Per-link condition number of the base columns its parameters
        contribute to (reference model.py:1054-1086). Works from an
        explicit stacked regressor / base Gram (block selection), the
        model's materialized YBase, or the streamed base Gram."""
        minTol = float(self.opt["minTol"])
        if YBase is None and G is None:
            YBase = self.YBase
            if YBase is None:
                # streaming mode (materializeRegressor=0): the column
                # subregressor is never stacked, but cond2(Y[:, cols]) =
                # sqrt(cond2(G[cols, cols])) from the base Gram
                G = getattr(self, "G_base", None)
                if G is None:
                    raise ValueError(
                        "subregressor condition numbers need computeRegressors "
                        "to have run (YBase or the streamed base Gram)"
                    )
        conds = []
        for i in range(self.num_links):
            cols = []
            for k in range(i * 10, i * 10 + 10):
                try:
                    ci = self.identified_params.index(k)
                except ValueError:
                    continue
                for j in range(self.num_base_params):
                    if abs(self.K[j, ci]) > minTol and j not in cols:
                        cols.append(j)
            if not cols:
                conds.append(1e16)
            elif YBase is not None:
                conds.append(float(np.linalg.cond(YBase[:, cols])))
            else:
                sub = np.asarray(G)[np.ix_(cols, cols)]
                ev = np.linalg.eigvalsh(sub)
                lo_ev = float(ev[0])
                conds.append(
                    1e16 if lo_ev <= 0 else float(np.sqrt(ev[-1] / lo_ev))
                )
        return conds
