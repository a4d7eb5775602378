"""Multi-device sample and candidate sharding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flobaroid_tpu.dynamics.engine import DynamicsEngine
from flobaroid_tpu.models.urdf import load_urdf
from flobaroid_tpu.parallel.mesh import make_mesh, shard_batch, sharded_gram_fn

from test_dynamics import SIMPLE_URDF


def test_sharded_gram_matches_single_device():
    assert len(jax.devices()) >= 8, "conftest should provide 8 virtual devices"
    tree = load_urdf(SIMPLE_URDF)
    eng = DynamicsEngine(tree)
    mesh = make_mesh(8)
    N, n = 64, eng.num_dofs
    rng = np.random.default_rng(3)
    Q = rng.uniform(-1, 1, (N, n))
    DQ = rng.standard_normal((N, n))
    DDQ = rng.standard_normal((N, n))
    TAU = rng.standard_normal((N, n))
    fn = sharded_gram_fn(eng, mesh)
    Qs, DQs, DDQs, TAUs = shard_batch(mesh, Q, DQ, DDQ, TAU)
    G, g = fn(Qs, DQs, DDQs, TAUs)

    Y = eng.regressor_batch(jnp.asarray(Q), jnp.asarray(DQ), jnp.asarray(DDQ))
    Yf = np.asarray(Y).reshape(-1, Y.shape[-1])
    G_ref = Yf.T @ Yf
    g_ref = Yf.T @ TAU.reshape(-1)
    np.testing.assert_allclose(np.asarray(G), G_ref, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(g), g_ref, rtol=1e-8, atol=1e-8)


def test_graft_entry_single_chip():
    import __graft_entry__ as g

    fn, args = g.entry()
    G, tau = jax.jit(fn)(*args)
    assert G.shape[0] == G.shape[1]
    assert np.all(np.isfinite(np.asarray(tau)))


@pytest.mark.slow
@pytest.mark.timeout(360)
def test_graft_dryrun_multichip():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


@pytest.mark.slow
@pytest.mark.timeout(120)
def test_streaming_gram_sharded_matches_unsharded():
    """shardSamples>1: the streaming identification shards each Gram
    chunk's sample axis over the device mesh; results must match the
    single-device path exactly (same jitted contraction, psum over the
    mesh)."""
    import os

    from test_identification import base_opt, synth_samples
    from flobaroid_tpu.identification.identifier import Identification

    REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    urdf = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
    assert len(jax.devices()) >= 8
    samples, _ = synth_samples(urdf, n=900, noise=0.05, seed=17)

    res = {}
    for shards in (0, 8):
        idf = Identification(
            base_opt(floatingBase=0, materializeRegressor=0,
                     gramChunk=256, shardSamples=shards),
            urdf,
        )
        idf.data.init_from_data(dict(samples))
        idf.estimateParameters()
        res[shards] = (np.asarray(idf.model.xBase), np.asarray(idf.model.G_std))

    np.testing.assert_allclose(res[8][0], res[0][0], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(res[8][1], res[0][1], rtol=1e-8)


@pytest.mark.timeout(120)
def test_walking_contact_sharded_matches_unsharded():
    """The HARDEST multi-chip path (VERDICT r3 #4): floating base +
    foot-contact wrenches through the fused streamed pipeline
    (model._walk_gram_fused: regressor + contact J^T w + device tau
    assembly + Grams in one dispatch) with the sample axis sharded over
    the 8-device mesh — parity with the unsharded run on xBase, the
    Gram and the contact torque contribution."""
    import os
    import shutil

    from flobaroid_tpu.identification.identifier import Identification
    from flobaroid_tpu.simulation.scenarios import walking_contact_scenario
    from flobaroid_tpu.utils.config import load_config

    assert len(jax.devices()) >= 8
    REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    src = os.path.join(REPO, "examples", "models", "humanoid30.urdf")

    import tempfile

    tmp = tempfile.mkdtemp(prefix="flobaroid_walkshard_")
    urdf = os.path.join(tmp, "humanoid30.urdf")
    shutil.copy(src, urdf)
    cache = src + ".regressor.npz"
    if os.path.exists(cache):
        shutil.copy(cache, urdf + ".regressor.npz")

    def opt_for(shards):
        return load_config(None, overrides=dict(
            floatingBase=1, identifyFrictionSimultaneously=1,
            identifySymmetricVelFriction=1, useStructuralRegressor=1,
            randomSamples=2000, materializeRegressor=0,
            estimateWith="std", constrainToConsistent=0,
            # f64: the parity bound tests the SHARDING, not f32
            # reduction-order noise (~5e-5 on the Gram at this scale)
            computeDtype="float64",
            gramChunk=96, shardSamples=shards, verbose=0,
        ))

    gen = Identification(opt_for(0), urdf)
    # the sample guard needs N > 2 * num_identified_params (= 430)
    samples, _, cf_true = walking_contact_scenario(
        gen.model, N=896, freq=200.0, seed=5, torque_noise=0.02,
        wrench_noise=0.3,
    )

    res = {}
    res_err = {}
    for shards in (0, 8):
        idf = Identification(opt_for(shards), urdf)
        idf.data.init_from_data(dict(samples))
        idf.estimateParameters()
        m = idf.model
        res[shards] = (
            np.asarray(m.xBase),
            np.asarray(m.G_base),
            np.asarray(m.contactForcesSum),
        )
        res_err[shards] = float(idf.res_error)
    for a, b in zip(res[8], res[0]):
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)
        assert rel < 1e-8, rel
    # and the sharded run actually fits the contact scenario (parameter
    # recovery at the production f32 dtype is proven in test_contacts;
    # in f64 the noise-dominated weak base directions are deliberately
    # not truncated, so the residual is the meaningful fit metric here)
    assert res_err[8] < 1.0, res_err
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.timeout(120)
def test_sharded_candidate_batch_matches_unsharded():
    """shardCandidates>1: the global-search candidate batch shards its
    leading axis over the device mesh (the SPMD form of the
    reference's Optuna worker processes, optimizer.py:52-147); values
    must match the unsharded evaluation, including a non-divisible
    batch size (padding sliced off)."""
    import os

    from flobaroid_tpu.excitation.objective import TrajectoryObjective
    from flobaroid_tpu.excitation.optimizer import build_bounds
    from flobaroid_tpu.excitation.trajectory import FourierSpec
    from flobaroid_tpu.model import Model
    from flobaroid_tpu.utils.config import load_config

    assert len(jax.devices()) >= 8
    REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    urdf = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
    opt = load_config(None, overrides=dict(
        floatingBase=0, useStructuralRegressor=1, randomSamples=500,
        trajectoryDuration=2.0, trajectorySamplingRate=50.0,
        checkCollisions=0, verbose=0,
    ))
    m = Model(dict(opt), urdf)
    lims = m.limits
    nf = tuple(2 for _ in m.jointNames)
    limits = tuple(
        (float(lims[j]["lower"]), float(lims[j]["upper"])) for j in m.jointNames
    )
    spec = FourierSpec(nf=nf, limits=limits)
    obj = TrajectoryObjective(m, dict(opt), spec)
    rng = np.random.default_rng(11)
    lo, hi = build_bounds(spec, opt)
    X = lo + (hi - lo) * rng.random((13, len(lo)))  # 13: not divisible by 8
    obj.calibrate_scale(X[0])

    f0, g0, n0 = obj.evaluate_batch(X)
    obj.config["shardCandidates"] = 8
    f8, g8, n8 = obj.evaluate_batch(X)
    assert f8.shape == f0.shape and g8.shape == g0.shape
    np.testing.assert_allclose(f8, f0, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(g8, g0, rtol=1e-6, atol=1e-8)
    np.testing.assert_array_equal(n8, n0)


def test_make_mesh_refuses_more_devices_than_visible():
    n = len(jax.devices())
    assert make_mesh(n).size == n
    with pytest.raises(ValueError, match=f"only {n} are visible"):
        make_mesh(n + 8)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("option", ["shardSamples", "shardCandidates"])
def test_shard_option_beyond_device_count_raises(option):
    """A sharding option larger than the visible device count is an
    error, never a silent unsharded run."""
    import os

    from test_identification import base_opt, synth_samples
    from flobaroid_tpu.excitation.objective import TrajectoryObjective
    from flobaroid_tpu.excitation.optimizer import build_bounds
    from flobaroid_tpu.excitation.trajectory import FourierSpec
    from flobaroid_tpu.identification.identifier import Identification

    REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    urdf = os.path.join(REPO, "examples", "models", "sevenlink_arm.urdf")
    too_many = len(jax.devices()) + 8
    if option == "shardSamples":
        samples, _ = synth_samples(urdf, n=400, noise=0.05, seed=3)
        idf = Identification(base_opt(
            floatingBase=0, materializeRegressor=0, gramChunk=128,
            randomSamples=500, shardSamples=too_many), urdf)
        idf.data.init_from_data(dict(samples))
        with pytest.raises(ValueError, match="shardSamples"):
            idf.estimateParameters()
    else:
        opt = base_opt(floatingBase=0, randomSamples=500,
                       trajectoryDuration=2.0, checkCollisions=0)
        from flobaroid_tpu.model import Model

        m = Model(dict(opt), urdf)
        lims = m.limits
        spec = FourierSpec(nf=tuple(2 for _ in m.jointNames), limits=tuple(
            (float(lims[j]["lower"]), float(lims[j]["upper"]))
            for j in m.jointNames))
        obj = TrajectoryObjective(m, dict(opt), spec)
        lo, hi = build_bounds(spec, opt)
        X = lo + (hi - lo) * np.random.default_rng(2).random((4, len(lo)))
        obj.calibrate_scale(X[0])
        obj.config["shardCandidates"] = too_many
        with pytest.raises(ValueError, match="shardCandidates"):
            obj.evaluate_batch(X)
