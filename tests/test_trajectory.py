"""Trajectory generation + D-optimal excitation optimization."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from flobaroid_tpu.excitation.objective import TrajectoryObjective
from flobaroid_tpu.excitation.optimizer import (
    amplitude_repair,
    initial_candidate,
    optimize_trajectory,
)
from flobaroid_tpu.excitation.trajectory import (
    FourierSpec,
    PulsedTrajectory,
    fourier_traj,
    minimum_jerk_transition,
)
from flobaroid_tpu.model import Model
from flobaroid_tpu.utils.config import load_config

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARM_URDF = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")


def test_fourier_derivative_consistency():
    """Sampled V/A must match numeric derivatives of Q (both modes)."""
    rng = np.random.default_rng(0)
    for limits in [None, ((-1.0, 1.2), (-2.0, 0.5), (-1.5, 1.5))]:
        spec = FourierSpec(nf=(3, 2, 4), limits=limits)
        x = rng.standard_normal(spec.dim) * 0.3
        x[0] = 0.8  # wf
        dt = 1e-5
        t = np.linspace(0.3, 5.0, 40)
        Q, V, A = fourier_traj(spec, jnp.asarray(x), t)
        Qp, _, _ = fourier_traj(spec, jnp.asarray(x), t + dt)
        Qm, _, _ = fourier_traj(spec, jnp.asarray(x), t - dt)
        V_num = (np.asarray(Qp) - np.asarray(Qm)) / (2 * dt)
        A_num = (np.asarray(Qp) - 2 * np.asarray(Q) + np.asarray(Qm)) / dt**2
        np.testing.assert_allclose(np.asarray(V), V_num, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(A), A_num, rtol=1e-3, atol=1e-3)
        if limits is not None:
            lo = np.array([l[0] for l in limits])
            hi = np.array([l[1] for l in limits])
            assert np.all(np.asarray(Q) >= lo - 1e-9)
            assert np.all(np.asarray(Q) <= hi + 1e-9)


def test_pulsed_trajectory_object_api():
    traj = PulsedTrajectory(3).initWithRandomParams(np.random.default_rng(1))
    traj.setTime(0.5)
    for d in range(3):
        assert np.isfinite(traj.getAngle(d))
        assert np.isfinite(traj.getVelocity(d))
    assert traj.getPeriodLength() > 0
    # classic mode offset convention: q(t) includes nf*q0 (reference
    # OscillationGenerator.getAngle, trajectoryGenerator.py:427-436)
    spec = FourierSpec(nf=(1,))
    x = spec.join(1.0, [0.3], [np.array([0.0])], [np.array([0.0])])
    Q, _, _ = fourier_traj(spec, jnp.asarray(x), np.array([0.0]))
    np.testing.assert_allclose(float(Q[0, 0]), 1 * 0.3)


def test_minimum_jerk_endpoints():
    t, q, v, a = minimum_jerk_transition(np.zeros(2), np.array([1.0, -0.5]), 2.0, 100.0)
    np.testing.assert_allclose(q[0], 0, atol=1e-12)
    np.testing.assert_allclose(q[-1], [1.0, -0.5], atol=1e-9)
    np.testing.assert_allclose(v[0], 0, atol=1e-9)
    np.testing.assert_allclose(v[-1], 0, atol=1e-6)
    np.testing.assert_allclose(a[-1], 0, atol=1e-4)


@pytest.fixture(scope="module")
def arm_model(tmp_path_factory):
    import shutil

    d = tmp_path_factory.mktemp("traj_arm")
    urdf = str(d / "arm.urdf")
    shutil.copy(ARM_URDF, urdf)
    opt = load_config(
        None,
        overrides=dict(
            floatingBase=0,
            useStructuralRegressor=1,
            randomSamples=800,
            computeDtype="float64",
            excitationFrequency=50.0,
            trajectoryPulseMin=1.0,
            trajectoryPulseMax=2.0,
            trajectoryDefaultNf=3,
            globalOptSize=8,
            globalOptIterations=4,
            localOptIterations=2,
            verbose=0,
        ),
    )
    model = Model(opt, urdf)
    return model, opt, urdf


@pytest.mark.slow
@pytest.mark.timeout(120)
def test_objective_gradient_flows(arm_model):
    model, opt, _ = arm_model
    nf = tuple([3] * model.num_dofs)
    lims = model.limits
    spec = FourierSpec(
        nf=nf,
        limits=tuple((lims[j]["lower"], lims[j]["upper"]) for j in model.jointNames),
    )
    obj = TrajectoryObjective(model, opt, spec, dtype=jnp.float64)
    x0 = initial_candidate(spec, opt, np.random.default_rng(0))
    obj.calibrate_scale(x0)
    f, g, n_obs = obj.evaluate(x0)
    assert np.isfinite(f) and np.all(np.isfinite(g))
    v, grad = obj.penalized_value_and_grad(x0, 10.0)
    assert np.all(np.isfinite(grad)) and np.linalg.norm(grad) > 0
    # gradient check vs finite differences on a few coords
    eps = 1e-6
    for k in [0, 1, spec.dim // 2, spec.dim - 1]:
        xp = x0.copy(); xp[k] += eps
        xm = x0.copy(); xm[k] -= eps
        fd = (obj._penalized(jnp.asarray(xp), obj.dopt_scale, 10.0, obj._shift_j)
              - obj._penalized(jnp.asarray(xm), obj.dopt_scale, 10.0, obj._shift_j)
              ) / (2 * eps)
        np.testing.assert_allclose(grad[k], float(fd), rtol=8e-3, atol=1e-3)


@pytest.mark.slow
@pytest.mark.timeout(300)
def test_optimize_trajectory_improves(arm_model):
    model, opt, _ = arm_model
    x, spec, obj, info = optimize_trajectory(model, dict(opt))
    assert info["feasible"], info
    # optimized trajectory must carry more information than the initial one
    x0 = initial_candidate(spec, opt, np.random.default_rng(0))
    x0r, ok = amplitude_repair(obj, x0)
    f0, g0, n0 = obj.evaluate(x0r)
    assert info["f"] <= f0 + 1e-6, (info["f"], f0)
    assert info["n_observable"] >= n0
    # limits hold on a fine resampling
    from flobaroid_tpu.excitation.trajectory import fourier_traj as ft

    t = np.arange(int(50.0 * 2 * np.pi / x[0])) / 50.0
    Q, V, A = ft(spec, jnp.asarray(x), t)
    lims = model.limits
    lo = np.array([lims[j]["lower"] for j in model.jointNames])
    hi = np.array([lims[j]["upper"] for j in model.jointNames])
    vl = np.array([lims[j]["velocity"] for j in model.jointNames])
    assert np.all(np.asarray(Q) >= lo - 1e-6) and np.all(np.asarray(Q) <= hi + 1e-6)
    assert np.all(np.abs(np.asarray(V)) <= vl * 1.02)


@pytest.mark.timeout(120)
def test_objective_matches_model_layout_with_stribeck(arm_model):
    """The objective's friction-column layout must track the model's
    identified-column count (Pb rows): stribeckVelocity adds an Fs
    block that was previously missing -> shape mismatch on the first
    evaluation."""
    from flobaroid_tpu.excitation.objective import TrajectoryObjective
    from flobaroid_tpu.excitation.optimizer import initial_candidate
    from flobaroid_tpu.model import Model
    from flobaroid_tpu.utils.config import load_config
    import os

    REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    urdf = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
    opt = load_config(None, overrides=dict(
        floatingBase=0, useStructuralRegressor=1, randomSamples=500,
        identifyFrictionSimultaneously=1, identifySymmetricVelFriction=1,
        stribeckVelocity=0.1, computeDtype="float64",
        trajectoryDefaultNf=2, verbose=0,
    ))
    model = Model(dict(opt), urdf)
    nf = tuple([2] * model.num_dofs)
    lims = model.limits
    spec = FourierSpec(nf=nf, limits=tuple(
        (lims[j]["lower"], lims[j]["upper"]) for j in model.jointNames))
    obj = TrajectoryObjective(model, dict(opt), spec, dtype=jnp.float64)
    x0 = initial_candidate(spec, opt, np.random.default_rng(3))
    obj.calibrate_scale(x0)
    f, g, n_obs = obj.evaluate(x0)
    assert np.isfinite(f) and np.all(np.isfinite(g))


@pytest.mark.slow
@pytest.mark.timeout(240)
def test_optimize_trajectory_classic_mode(arm_model):
    """trajectoryBounded: 0 (the reference's default, pulsed classic
    series): the optimizer runs with an unbounded FourierSpec and the
    position limits hold via the hard constraints instead of the tanh
    squash."""
    model, opt, _ = arm_model
    cfg = dict(opt, trajectoryBounded=0, globalOptSize=16,
               globalOptIterations=3, globalOptRestarts=1,
               localOptIterations=1, localOptStages=3)
    x, spec, obj, info = optimize_trajectory(model, cfg)
    assert spec.limits is None  # classic parameterization
    assert np.all(np.isfinite(x))
    f, g, _ = obj.evaluate(x)
    assert info["feasible"] == obj.feasible(g)
    if info["feasible"]:
        t = np.arange(int(50.0 * 2 * np.pi / x[0])) / 50.0
        Q, _, _ = __import__("flobaroid_tpu.excitation.trajectory",
                             fromlist=["fourier_traj"]).fourier_traj(
            spec, jnp.asarray(x), t)
        lims = model.limits
        lo = np.array([lims[j]["lower"] for j in model.jointNames])
        hi = np.array([lims[j]["upper"] for j in model.jointNames])
        assert np.all(np.asarray(Q) >= lo - 1e-3)
        assert np.all(np.asarray(Q) <= hi + 1e-3)


@pytest.mark.slow
@pytest.mark.timeout(300)
def test_trajectory_cli_then_simulator(tmp_path):
    """trajectory.py -> simulator.py CLI chain produces contract files."""
    cfg = dict(
        excitationFrequency=50.0,
        floatingBase=0,
        verbose=0,
        trajectoryPulseMin=1.0,
        trajectoryPulseMax=2.0,
        trajectoryDefaultNf=2,
        globalOptSize=8,
        globalOptIterations=2,
        localOptIterations=1,
        useStructuralRegressor=1,
        randomSamples=500,
        transitionDuration=1.0,
        simulateCableForces=0,
    )
    cfg_file = tmp_path / "cfg.yaml"
    with open(cfg_file, "w") as f:
        yaml.safe_dump(cfg, f)
    traj_file = tmp_path / "traj.npz"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "trajectory.py"),
         "--config", str(cfg_file), "--model", ARM_URDF,
         "--filename", str(traj_file)],
        capture_output=True, text=True, timeout=500, cwd=REPO, env=env,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(traj_file, allow_pickle=True) as f:
        for k in ("a", "b", "q", "nf", "wf", "positions", "velocities",
                  "accelerations", "times", "frequency", "unobservable_params",
                  "n_observable_base_params"):
            assert k in f.files, k
        assert not f["static"]

    meas_file = tmp_path / "meas.npz"
    r2 = subprocess.run(
        [sys.executable, os.path.join(REPO, "simulator.py"),
         "--config", str(cfg_file), "--model", ARM_URDF,
         "--trajectory", str(traj_file), "--filename", str(meas_file)],
        capture_output=True, text=True, timeout=500, cwd=REPO, env=env,
    )
    assert r2.returncode == 0, r2.stderr[-3000:]
    with np.load(meas_file, allow_pickle=True) as f:
        assert "torques" in f.files


@pytest.mark.timeout(90)
def test_posture_optimizer(arm_model):
    model, opt, _ = arm_model
    from flobaroid_tpu.excitation.posture import optimize_postures

    o = dict(opt)
    o.update(numStaticPostures=3, globalOptIterations=3, globalOptSize=8)
    angles = optimize_postures(model, o)
    assert len(angles) == 3
    lims = model.limits
    lo = np.array([lims[j]["lower"] for j in model.jointNames])
    hi = np.array([lims[j]["upper"] for j in model.jointNames])
    for a in angles:
        assert np.all(a >= lo - 1e-9) and np.all(a <= hi + 1e-9)


SUSPENDED_URDF = """
<robot name="susp">
  <link name="Waist">
    <inertial><mass value="6.0"/><origin xyz="0 0 -0.1"/>
      <inertia ixx="0.08" iyy="0.08" izz="0.05"/></inertial>
  </link>
  <link name="crane_ft"/>
  <joint name="crane_j" type="fixed">
    <origin xyz="0 0 0.4"/><parent link="Waist"/><child link="crane_ft"/>
  </joint>
  <joint name="j1" type="revolute">
    <origin xyz="0.1 0 -0.2"/><axis xyz="0 1 0"/>
    <parent link="Waist"/><child link="l1"/>
    <limit effort="40" lower="-1.5" upper="1.5" velocity="3"/>
  </joint>
  <link name="l1">
    <inertial><mass value="1.5"/><origin xyz="0.15 0 0"/>
      <inertia ixx="0.004" iyy="0.02" izz="0.02"/></inertial>
  </link>
  <joint name="j2" type="revolute">
    <origin xyz="0.3 0 0"/><axis xyz="0 0 1"/>
    <parent link="l1"/><child link="l2"/>
    <limit effort="25" lower="-1.5" upper="1.5" velocity="3"/>
  </joint>
  <link name="l2">
    <inertial><mass value="0.8"/><origin xyz="0.12 0 0"/>
      <inertia ixx="0.002" iyy="0.008" izz="0.008"/></inertial>
  </link>
</robot>
"""


@pytest.mark.slow
@pytest.mark.timeout(420)
def test_suspended_objective(tmp_path):
    """D-optimality objective with the suspended-base scan in the loop
    (walkman_full scenario): finite values, flowing gradients, feasible
    optimization result."""
    urdf = tmp_path / "susp.urdf"
    urdf.write_text(SUSPENDED_URDF)
    opt = load_config(
        None,
        overrides=dict(
            floatingBase=1,
            floatingBaseAttachment="suspended",
            floatingBaseAttachmentFrame="crane_ft",
            suspendedDamping=50.0,
            useStructuralRegressor=1,
            randomSamples=400,
            computeDtype="float64",
            excitationFrequency=50.0,
            trajectoryPulseMin=1.0,
            trajectoryPulseMax=2.0,
            trajectoryDefaultNf=2,
            globalOptSize=8,
            globalOptIterations=2,
            localOptIterations=1,
            verbose=0,
        ),
    )
    model = Model(opt, str(urdf))
    x, spec, obj, info = optimize_trajectory(model, dict(opt))
    assert obj.suspended is not None
    f, g, n_obs = obj.evaluate(x)
    assert np.isfinite(f) and np.all(np.isfinite(g))
    _, grad = obj.penalized_value_and_grad(x, 10.0)
    assert np.all(np.isfinite(grad)) and np.linalg.norm(grad) > 0
    assert info["feasible"], info


@pytest.mark.timeout(120)
def test_posture_optimizer_parity_objective(tmp_path):
    """Reference parity (postureOptimizer.py:93-180): with --model_real
    the objective is ||xBaseReal - xBase||^2 with the (gravity-only)
    identification run inside the loop."""
    from flobaroid_tpu.excitation.posture import optimize_postures
    from flobaroid_tpu.model import Model

    opt = load_config(
        None,
        overrides=dict(
            floatingBase=0,
            identifyGravityParamsOnly=1,
            identifyFrictionSimultaneously=0,
            useStructuralRegressor=1,
            randomSamples=400,
            computeDtype="float64",
            numStaticPostures=3,
            globalOptIterations=3,
            globalOptSize=8,
            useLocalOptimization=1,
            verbose=0,
        ),
    )
    model = Model(opt, ARM_URDF)
    x_real = np.asarray(model.tree.std_params())
    angles = optimize_postures(model, opt, x_std_real=x_real)
    assert len(angles) == 3
    lims = model.limits
    lo = np.array([lims[j]["lower"] for j in model.jointNames])
    hi = np.array([lims[j]["upper"] for j in model.jointNames])
    for a in angles:
        assert np.all(a >= lo - 1e-9) and np.all(a <= hi + 1e-9)

    # the optimized postures must identify the gravity base params from
    # exact simulated torques better than a mediocre fixed posture set
    import jax.numpy as jnp

    keep = [p for p in range(model.num_model_params) if p % 10 < 4]
    Pb = np.asarray(model.Pb)
    K = np.asarray(model.K)
    xb_real = K @ x_real[keep]

    def ident_err(Qs):
        Z = jnp.zeros_like(Qs)
        Y = model.engine.regressor_batch(jnp.asarray(Qs), Z, Z)
        Yf = np.asarray(Y[:, :, jnp.asarray(keep)]).reshape(-1, len(keep))
        YB = Yf @ Pb
        tau = Yf @ x_real[keep]
        xb = np.linalg.lstsq(YB, tau, rcond=None)[0]
        return np.linalg.norm(xb - xb_real)

    err_opt = ident_err(np.stack(angles))
    err_fixed = ident_err(np.stack([np.full(model.num_dofs, 0.1 * i) for i in range(3)]))
    assert err_opt <= err_fixed + 1e-9

    # wrong model mode fails loudly
    opt_full = dict(opt)
    opt_full["identifyGravityParamsOnly"] = 0
    model_full = Model(opt_full, ARM_URDF)
    with pytest.raises(ValueError, match="identifyGravityParamsOnly"):
        optimize_postures(model_full, opt_full, x_std_real=x_real)


def _arm_objective_and_batch(arm_model, n=5):
    model, opt, _ = arm_model
    lims = model.limits
    spec = FourierSpec(
        nf=tuple([2] * model.num_dofs),
        limits=tuple((lims[j]["lower"], lims[j]["upper"]) for j in model.jointNames),
    )
    obj = TrajectoryObjective(model, dict(opt), spec)
    from flobaroid_tpu.excitation.optimizer import build_bounds

    lo, hi = build_bounds(spec, opt)
    X = lo + (hi - lo) * np.random.default_rng(4).random((n, len(lo)))
    obj.calibrate_scale(X[0])
    return obj, X, lo, hi


@pytest.mark.timeout(120)
def test_evaluate_batch_full_width_matches_loop(arm_model):
    """The whole population runs as one full-width vmap on every
    platform; each candidate's value, constraints and observable count
    must match its own single evaluation."""
    obj, X, _, _ = _arm_objective_and_batch(arm_model)
    f, g, n_obs = obj.evaluate_batch(X)
    assert f.shape == (len(X),) and g.shape[0] == len(X)
    for i, x in enumerate(X):
        fi, gi, ni = obj.evaluate(x)
        np.testing.assert_allclose(f[i], fi, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g[i], gi, rtol=1e-5, atol=1e-6)
        assert n_obs[i] == ni


@pytest.mark.timeout(120)
def test_al_refine_batch_matches_loop(arm_model):
    """K augmented-Lagrangian restarts in one vmapped dispatch equal K
    separate single-start stages (per-candidate multipliers and
    penalties)."""
    obj, X, lo, hi = _arm_objective_and_batch(arm_model, n=3)
    _, g0, _ = obj.evaluate(X[0])
    LAM = np.abs(np.random.default_rng(5).standard_normal((len(X), g0.size)))
    RHO = np.array([1.0, 2.0, 4.0])
    Xb = obj.al_refine_batch(X, lo, hi, LAM, RHO, lr=0.01, n_steps=3)
    assert Xb.shape == X.shape
    for i in range(len(X)):
        xi, _ = obj.al_refine(X[i], lo, hi, LAM[i], RHO[i], lr=0.01, n_steps=3)
        np.testing.assert_allclose(Xb[i], xi, rtol=1e-4, atol=1e-5)
