#!/usr/bin/env python
"""Walkman-class end-to-end flow on the bundled 30-DOF humanoid:
suspended-base D-optimal trajectory optimization -> measurement
simulation (ball-joint base + effect chain) -> SDP-constrained
identification with friction. Mirrors the reference's walkman_full
scenario (BASELINE.json config #5). Its time on the H100 is not
measured; the persistent compile cache shortens repeat runs."""
import numpy as np, time, tempfile, os, shutil, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax, jax.numpy as jnp
from flobaroid_tpu.utils.cli import enable_compilation_cache
from flobaroid_tpu.model import Model
from flobaroid_tpu.utils.config import load_config
from flobaroid_tpu.excitation.optimizer import optimize_trajectory
from flobaroid_tpu.excitation.trajectory import fourier_traj
from flobaroid_tpu.identification.identifier import Identification
from simulator import simulate_measurements

enable_compilation_cache()
print("device:", jax.devices()[0], flush=True)
tmp = tempfile.mkdtemp(); urdf = os.path.join(tmp, "humanoid30.urdf")
shutil.copy("examples/models/humanoid30.urdf", urdf)
# reuse the bundled structural-regressor QR cache (options match; a cold
# random-regressor pass compiles and runs for minutes)
if os.path.exists("examples/models/humanoid30.urdf.regressor.npz"):
    shutil.copy("examples/models/humanoid30.urdf.regressor.npz",
                urdf + ".regressor.npz")
opt = load_config(None, overrides=dict(
    floatingBase=1, floatingBaseAttachment="suspended",
    floatingBaseAttachmentFrame="crane_ft", suspendedDamping=500.0,
    useStructuralRegressor=1, randomSamples=2000,
    excitationFrequency=50.0, trajectoryPulseMin=1.0, trajectoryPulseMax=1.6,
    trajectoryDefaultNf=3, globalOptSize=12, globalOptIterations=4,
    localOptIterations=2, trajectoryTargetVelocity=0.8, verbose=0))
t0=time.time()
model = Model(opt, urdf)
print(f"model+structural QR: {time.time()-t0:.1f}s, num_base={model.num_base_params}", flush=True)
t0=time.time()
x, spec, obj, info = optimize_trajectory(model, dict(opt))
print(f"suspended trajectory opt: {time.time()-t0:.1f}s {info}", flush=True)

freq = 50.0
periods = int(os.environ.get("FLOW_PERIODS", "10"))  # friction recovery wants 13k+ samples (BASELINE)
times = np.arange(int(2*np.pi/x[0]*freq)*periods) / freq
Q, V, A = (np.asarray(v) for v in fourier_traj(spec, jnp.asarray(x, jnp.float32), times))
cfg = dict(opt); cfg.update(urdf=urdf, num_dofs=30, jointNames=model.jointNames,
    simulateCableForces=0, simulateGravityCompResidual=0, simulateThermalDrift=0, simulateTimingJitter=0)
t0=time.time()
meas = simulate_measurements(cfg, {"times": times, "positions": Q, "velocities": V, "accelerations": A}, interactive=False)
print(f"simulate (suspended + effects): {time.time()-t0:.1f}s", flush=True)
np.savez(os.path.join(tmp,"m.npz"), **meas)

iopt = load_config(None, overrides=dict(floatingBase=1,
    identifyFrictionSimultaneously=1, identifySymmetricVelFriction=1,
    constrainToConsistent=1, limitOverallMass=1, limitMassRange=5.0,
    limitMassToApriori=1, limitMassAprioriBoundary=0.5,
    cadRegularizationMode="observability",
    useStructuralRegressor=1, randomSamples=2000,
    materializeRegressor=0,  # stream Grams: faster + memory-unbounded at 30 DOF
    estimateWith="std", verbose=0))
t0=time.time()
idf = Identification(iopt, urdf)
idf.data.init_from_files([[os.path.join(tmp,"m.npz")]])
idf.data.preprocess(imu=False)
idf.estimateParameters()
print(f"identify (two-step): {time.time()-t0:.1f}s", flush=True)
rel = np.linalg.norm(idf.model.xBase - idf.model.xBaseModel)/np.linalg.norm(idf.model.xBaseModel)
print(f"res_error {idf.res_error:.3f}%, base-param distance {rel:.4f}", flush=True)
xf = idf._full_xstd()
fs = idf.model.friction_params_start; nd = idf.model.num_dofs
print("Fc (sim truth 0.4):", xf[fs:fs+8].round(3), flush=True)
print("Fv (sim truth 0.7):", xf[fs+nd:fs+nd+8].round(3), flush=True)
from flobaroid_tpu.utils.helpers import is_physical_consistent
print("consistent:", is_physical_consistent(xf[:idf.model.num_model_params], idf.model.num_links), "sdp:", idf.sdp.last_status, flush=True)
print("ALLDONE", flush=True)
