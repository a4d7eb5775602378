#!/usr/bin/env python
"""Prove that the main paths run on an NVIDIA GPU and give right answers.

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # the sharded paths on four GPUs

One process drives the card(s). Phases, in order (one GPU):

  device      JAX must report platform 'gpu'; prints the card's name and
              power limit, the compile-cache directory and XLA_FLAGS
  engine      30-DOF floating-base regressor Y and RNEA torques in f32 on
              the card; Y @ pi == RNEA, and both against the Euler-Lagrange
              oracle (dynamics/lagrangian.py) in f64 on the host CPU
  identify7   bench.py's 7-DOF simulate + OLS->SDP identify leg
  humanoid30  bench.py's 30-DOF walking-contact streamed identify leg,
              13,770 samples, SDP included
  trajectory  7-DOF D-optimal trajectory optimization, and one candidate
              batch at the default population of 256
  gram        the production Gram einsum at (495,720 x 430) f32, timed

With --four only the sharded production paths run, each against the same
path on one card: the 30-DOF walking identify with shardSamples=4, one
CEM generation with shardCandidates=4, and the structural random-
regressor Gram with shardSamples=4.

Any failed check exits non-zero. Without a GPU the script exits non-zero
and prints no result. Times are printed with the card's name and power
limit; they are facts of this run, not benchmarks. The last line of
standard output is the JSON line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# published NVIDIA H100 SXM rates (data sheet; dense, no sparsity)
H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12  # float32 outside the tensor cores

# the excitation values of examples/configs/sevenlink_arm.yaml, as
# overrides: this path needs no YAML parser
SEVENLINK_TRAJECTORY = dict(
    floatingBase=0, useStructuralRegressor=1, randomSamples=2000,
    identifyFrictionSimultaneously=1, identifySymmetricVelFriction=1,
    globalOptSize=24, globalOptIterations=8, localOptIterations=4,
    trajectoryPulseInit=1.0, trajectoryPulseMin=0.7, trajectoryPulseMax=1.5,
    trajectoryCoeffInit=0.4, trajectoryCoeffMin=-0.8, trajectoryCoeffMax=0.8,
    trajectoryDefaultNf=4, trajectoryTargetVelocity=0.5,
    excitationFrequency=100.0, transitionDuration=2.0, verbose=0,
)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED {what}")


def rel(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def peak(card: str) -> str:
    """Process-wide peak of device memory in use (`peak_bytes_in_use`)."""
    import jax

    b = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    gib = "not reported" if b is None else f"{b} B ({b / 2**30:.3f} GiB)"
    return f"process peak device memory so far {gib} [{card}]"


def device_phase() -> dict:
    import jax

    from flobaroid_tpu.utils.cli import setup_jax
    from flobaroid_tpu.utils.device import require_gpu

    cache_dir = setup_jax()
    dev = require_gpu()
    log(f"[device] platform={dev['platform']} kind={dev['kind']} "
        f"count={dev['count']} jax={jax.__version__}")
    log(f"[device] card (name, power limit): {dev['card']}")
    log(f"[device] compile cache: {cache_dir}; "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    return dev


def engine_phase(card: str, n_states: int = 2000, n_ref: int = 256,
                 seed: int = 0) -> None:
    """Regressor-RNEA identity on the card, and both against the plain
    reference. Tolerance ≤ 1e-5 relative for each, in f32 under the
    engine's `highest` guard: the f32 floor of a 34-link chain is ~1e-7
    (the same graph on the host CPU in f32), and TF32 would show ~1e-3.
    The f64 oracle is fed the same f32-rounded states."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flobaroid_tpu.dynamics import lagrangian as lag
    from flobaroid_tpu.dynamics.engine import DynamicsEngine, rpy_to_base_rot
    from flobaroid_tpu.models.urdf import load_urdf

    tree = load_urdf(os.path.join(HERE, "examples", "models", "humanoid30.urdf"))
    n = tree.num_dofs
    lims = tree.joint_limits()
    lo = np.array([lims[j]["lower"] for j in tree.dof_names])
    hi = np.array([lims[j]["upper"] for j in tree.dof_names])
    vl = np.array([min(lims[j]["velocity"], 10.0) for j in tree.dof_names])
    rng = np.random.default_rng(seed)
    N = n_states
    # random in-limit states; the base moves with rpy rates; every input
    # is rounded to f32 once, so card and oracle see the same state
    state = [
        lo + (hi - lo) * rng.random((N, n)),
        (2 * rng.random((N, n)) - 1) * vl,
        (2 * rng.random((N, n)) - 1) * np.pi,
        0.4 * rng.standard_normal((N, 3)),
    ] + [rng.standard_normal((N, 3)) for _ in range(4)]
    q, dq, ddq, rpy, drpy, ddrpy, dpb, ddpb = (
        np.asarray(a, np.float32).astype(np.float64) for a in state
    )
    pi64 = np.asarray(tree.std_params(), dtype=np.float64)

    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        eng64 = DynamicsEngine(tree)

        def base_args(rpy, drpy, ddrpy, dpb, ddpb):
            w, wd = jax.jvp(lambda r, rd: lag.omega_world(r, rd),
                            (rpy, drpy), (drpy, ddrpy))
            return (rpy_to_base_rot(rpy), jnp.concatenate([dpb, w]),
                    jnp.concatenate([ddpb, wd]))

        BR, BV, BA = (np.asarray(a) for a in jax.jit(jax.vmap(base_args))(
            rpy, drpy, ddrpy, dpb, ddpb))
        t0 = time.time()
        tau_ref = np.asarray(jax.jit(jax.vmap(
            lambda *a: lag.inverse_dynamics_floating(eng64, pi64, *a)
        ))(q[:n_ref], dq[:n_ref], ddq[:n_ref], rpy[:n_ref], drpy[:n_ref],
           ddrpy[:n_ref], dpb[:n_ref], ddpb[:n_ref]))
        log(f"[engine] Euler-Lagrange oracle, f64 on host CPU, {n_ref} "
            f"states: {time.time() - t0:.1f} s")

    gpu = jax.devices()[0]
    args = [jax.device_put(np.asarray(a, np.float32), gpu)
            for a in (q, dq, ddq, BR, BV, BA)]
    pi32 = jax.device_put(np.asarray(pi64, np.float32), gpu)

    def measure(eng, label):
        fn = jax.jit(lambda *a: (eng.regressor_batch(*a),
                                 eng.inverse_dynamics_batch(pi32, *a)))
        t0 = time.time()
        Y, tau = jax.block_until_ready(fn(*args))
        t_first = time.time() - t0
        Y = np.asarray(Y, dtype=np.float64)
        tau = np.asarray(tau, dtype=np.float64)
        Ypi = Y @ pi64
        errs = dict(identity=rel(Ypi, tau),
                    regressor_vs_oracle=rel(Ypi[:n_ref], tau_ref),
                    rnea_vs_oracle=rel(tau[:n_ref], tau_ref))
        check(Y.shape == (N, 6 + n, 10 * tree.num_links)
              and np.all(np.isfinite(Y)), f"engine {label}: Y shape/finite")
        log(f"[engine] {label}: Y {Y.shape} f32 on {gpu.device_kind}; "
            f"first call (compile+run) {t_first:.1f} s [{card}]")
        log(f"[engine] {label}: |Y@pi - RNEA|/|RNEA| = {errs['identity']:.3e}; "
            f"vs f64 oracle: Y@pi {errs['regressor_vs_oracle']:.3e}, "
            f"RNEA {errs['rnea_vs_oracle']:.3e}")
        return errs

    e = measure(DynamicsEngine(tree), "precision=highest")
    check(e["identity"] <= 1e-5,
          f"engine identity {e['identity']:.3e} > 1e-5")
    check(e["regressor_vs_oracle"] <= 1e-5 and e["rnea_vs_oracle"] <= 1e-5,
          f"engine vs oracle {e} > 1e-5")
    log("[engine] asserted: identity and each vs oracle <= 1e-5")

    class DefaultPrecisionEngine(DynamicsEngine):
        """The engine without its full-precision guards: XLA's default
        matmul precision, which lets the card use TF32 for f32."""

        fk = DynamicsEngine.fk.__wrapped__
        regressor = DynamicsEngine.regressor.__wrapped__
        inverse_dynamics = DynamicsEngine.inverse_dynamics.__wrapped__

    measure(DefaultPrecisionEngine(tree), "precision=default (printed only)")


def identify7_phase(card: str) -> None:
    import bench

    _, _, d = bench.run_sevenlink(n_samples=2000, passes=3)
    log(f"[identify7] residual {d['torque_residual_pct']} % (< 1), base rel "
        f"err {d['base_param_rel_err']} (< 0.05), consistent "
        f"{d['physically_consistent']}, SDP {d['sdp_status']}")
    log(f"[identify7] first pass (compile+set-up) {d['first_pass_s']} s; warm "
        f"min {d['wallclock_s']} / mean {d['wallclock_mean_s']} s over 3; "
        f"stages {d['stage_times_s']} [{card}]")
    log(f"[identify7] {peak(card)}")
    check(d["torque_residual_pct"] < 1.0, "identify7 residual")
    check(d["base_param_rel_err"] < 0.05, "identify7 base error")
    check(d["physically_consistent"], "identify7 consistency")
    check(d["sdp_status"] == "optimal", f"identify7 SDP {d['sdp_status']}")


def humanoid30_phase(card: str) -> None:
    import bench

    d = bench.run_humanoid30()
    log(f"[humanoid30] {d['n_samples']} samples, residual "
        f"{d['torque_residual_pct']} % (< 0.2), base distance "
        f"{d['base_param_distance']} (< 1e-3), SDP {d['sdp_status']}, "
        f"cond(YBase) {d['base_cond']}")
    log(f"[humanoid30] first pass (compile+set-up) {d['first_pass_s']} s; "
        f"warm min {d['wallclock_s']} / mean {d['wallclock_mean_s']} / max "
        f"{d['wallclock_max_s']} s over 5 [{card}]")
    log(f"[humanoid30] stages {d['stage_times_s']} [{card}]")
    log(f"[humanoid30] {peak(card)}")
    check(d["sdp_status"] == "optimal", f"humanoid30 SDP {d['sdp_status']}")
    check(d["torque_residual_pct"] < 0.2, "humanoid30 residual")
    check(d["base_param_distance"] < 1e-3, "humanoid30 base distance")


def trajectory_phase(card: str, population: int | None = None) -> None:
    import shutil
    import tempfile

    import jax.numpy as jnp
    import numpy as np

    from __graft_entry__ import arm_copy
    from flobaroid_tpu import native_meshdist
    from flobaroid_tpu.excitation.optimizer import build_bounds, optimize_trajectory
    from flobaroid_tpu.model import Model
    from flobaroid_tpu.utils.config import DEFAULTS, load_config

    opt = load_config(None, overrides=SEVENLINK_TRAJECTORY)
    tmpdir = tempfile.mkdtemp(prefix="flobaroid_smoke_traj_")
    try:
        model = Model(dict(opt), arm_copy(tmpdir))
        t0 = time.time()
        x, spec, obj, info = optimize_trajectory(model, dict(opt))
        wall = time.time() - t0
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    phases = {k: info[k] for k in ("t_global_s", "t_local_s", "t_mesh_s")
              if k in info}
    log(f"[trajectory] f={info['f']:.4f} feasible={info['feasible']} "
        f"n_observable={info['n_observable']} mesh_ok="
        f"{info.get('mesh_collision_ok')} native meshdist="
        f"{native_meshdist.available()}")
    log(f"[trajectory] optimize_trajectory {wall:.1f} s cold, phases "
        f"{phases} [{card}]")
    check(np.isfinite(info["f"]), "trajectory objective not finite")
    check(info["feasible"], "trajectory not feasible")

    pop = int(population or DEFAULTS["globalOptSize"])
    lo, hi = build_bounds(spec, opt)
    X = lo + (hi - lo) * np.random.default_rng(1).random((pop, len(lo)))
    compiled = obj._evaluate_batch.lower(
        jnp.asarray(X, obj.dtype), obj.dopt_scale, obj._shift_j).compile()
    mem = compiled.memory_analysis()
    if mem is not None:
        log(f"[trajectory] evaluate_batch({pop}) executable: temp "
            f"{mem.temp_size_in_bytes} B, arguments "
            f"{mem.argument_size_in_bytes} B, outputs "
            f"{mem.output_size_in_bytes} B")
    t0 = time.time()
    f, g, n_obs = obj.evaluate_batch(X)
    log(f"[trajectory] evaluate_batch({pop}) full width: "
        f"{time.time() - t0:.2f} s; {peak(card)}")
    check(f.shape == (pop,) and np.all(np.isfinite(f)),
          "evaluate_batch values")


def gram_phase(card: str, M: int = 495_720, P: int = 430, reps: int = 20) -> None:
    """The production plain Gram (einsum at HIGHEST, f32) on one
    device-resident array. Checked on a 16-column block against host
    f64 (≤ 1e-4 relative: f32 sums over M terms); its time is printed
    against the published HBM and FP32 bounds."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    Y = jax.random.normal(jax.random.PRNGKey(0), (M, P), jnp.float32)
    gram = jax.jit(lambda Y: jnp.einsum(
        "mp,mq->pq", Y, Y, precision=jax.lax.Precision.HIGHEST))
    G = np.asarray(gram(Y), dtype=np.float64)
    Yb = np.asarray(Y[:, :16], dtype=np.float64)
    err = rel(G[:16, :16], Yb.T @ Yb)
    check(np.all(np.isfinite(G)) and err <= 1e-4,
          f"gram block vs host f64 {err:.3e} > 1e-4")
    t0 = time.time()
    for _ in range(reps):
        out = gram(Y)
    out.block_until_ready()
    dt = (time.time() - t0) / reps
    nbytes, flops = 4 * M * P, 2 * M * P * P
    log(f"[gram] ({M} x {P}) f32 HIGHEST: {dt * 1e3:.3f} ms warm (mean of "
        f"{reps}); block vs host f64 {err:.2e} (<= 1e-4) [{card}]")
    log(f"[gram] {nbytes / dt / 1e9:.1f} GB/s = "
        f"{nbytes / dt / H100_HBM_BYTES_PER_S:.4f} of the 3.35 TB/s HBM "
        f"bound; {flops / dt / 1e12:.2f} TFLOP/s = "
        f"{flops / dt / H100_FP32_FLOPS:.4f} of the 67 TFLOP/s FP32 bound "
        f"(the larger bound: {'FP32' if flops / H100_FP32_FLOPS > nbytes / H100_HBM_BYTES_PER_S else 'HBM'})")


def four_phase(card: str, n_devices: int = 4, walk_samples: int = 13770,
               population: int = 256, gram_samples: int = 30_000) -> None:
    """The sharded production paths against one card, in f32. Tolerances
    allow for psum reassociation: Grams, contact torques and candidate
    values ≤ 1e-5 relative; the base parameters ≤ 1e-4 relative, because
    the OLS/SDP amplifies Gram perturbations by the base conditioning
    (7e-6 on four virtual CPU devices in f32). Each walking run must also
    meet the single-card fit limits on its own."""
    import bench
    from __graft_entry__ import cem_parity, random_gram_parity, walking_parity

    t0 = time.time()
    w = walking_parity(n_devices, walk_samples, bench.HUMANOID30_OVERRIDES)
    log(f"[four] walking identify, {walk_samples} samples, shardSamples="
        f"{n_devices} vs "
        f"one card: xBase {w['xBase_rel']:.3e}, G_base {w['G_base_rel']:.3e}, "
        f"contact torques {w['contact_torque_rel']:.3e}; sharded "
        f"{w['sharded']}; single {w['single']}; {time.time() - t0:.1f} s "
        f"[{card}]")
    check(w["G_base_rel"] <= 1e-5 and w["contact_torque_rel"] <= 1e-5,
          "walking sharded Gram/contact parity")
    check(w["xBase_rel"] <= 1e-4, "walking sharded xBase parity")
    for run in (w["sharded"], w["single"]):
        check(run["sdp_status"] == "optimal" and run["residual_pct"] < 0.2
              and run["truth_dist"] < 1e-3, f"walking fit {run}")

    t0 = time.time()
    c = cem_parity(n_devices, population, SEVENLINK_TRAJECTORY)
    log(f"[four] CEM generation, population {population}, shardCandidates="
        f"{n_devices} "
        f"vs one card: f {c['f_rel']:.3e}, g {c['g_rel']:.3e}, n_observable "
        f"equal {c['n_observable_equal']}; sharded generation best f "
        f"{c['generation_best_f']:.4f}; {time.time() - t0:.1f} s [{card}]")
    check(c["f_rel"] <= 1e-5 and c["g_rel"] <= 1e-5
          and c["n_observable_equal"] and c["generation_finite"],
          "CEM sharded parity")

    t0 = time.time()
    gerr = random_gram_parity(n_devices, gram_samples,
                              bench.HUMANOID30_OVERRIDES, bench.humanoid30_copy)
    log(f"[four] 30-DOF random-regressor Gram, {gram_samples} samples, "
        f"shardSamples="
        f"{n_devices} vs one card: {gerr:.3e}; {time.time() - t0:.1f} s "
        f"[{card}]")
    check(gerr <= 1e-5, "random-Gram sharded parity")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the sharded paths, on four GPUs")
    args = p.parse_args(argv)

    t_start = time.time()
    dev = device_phase()
    # one label for the printed times: "<name>, <power limit>" (x N cards)
    cards = dev["card"].splitlines()
    card = cards[0] + (f" (x{len(cards)})" if len(cards) > 1 else "")
    if args.four:
        check(dev["count"] >= 4, f"--four needs 4 GPUs, found {dev['count']}")
        four_phase(card)
    else:
        for name, phase in (("engine", engine_phase),
                            ("identify7", identify7_phase),
                            ("humanoid30", humanoid30_phase),
                            ("trajectory", trajectory_phase),
                            ("gram", gram_phase)):
            t0 = time.time()
            phase(card)
            log(f"[{name}] phase done in {time.time() - t0:.1f} s")
    log(f"[done] all phases passed in {time.time() - t_start:.1f} s")
    log(f"card: {dev['card']}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
