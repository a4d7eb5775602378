#!/usr/bin/env python
"""Convert CSV joint logs to the measurements npz contract.

Counterpart of the reference's tools/csv2npz.py (615 LoC): reads
per-channel CSV files (or one combined CSV), applies per-joint sign /
torque-offset corrections and CSV->URDF joint reordering, runs the
standard preprocessing chain (filtering + differentiation), and can
RESIMULATE torques from the model along the recorded motion — the
reference's gazebo mode (`is_gazebo`, reference tools/csv2npz.py:547-579),
used when the logged torques are unreliable but the kinematics are good.

The reference hardcodes two robots' CSV layouts (readCentauroCSV /
readWalkmanCSV); here the layout is CLI-driven:

  python tools/csv2npz.py --config cfg.yaml --model robot.urdf \
      --csv log.csv --time-col 0 --pos-cols 1:8 --tau-cols 8:15 \
      --joint-order 6,7,8,0,1,2,3 --joint-signs 1,-1,1,1,1,-1,1 \
      --resimulate-torques --out measurements.npz

Per-joint files (the reference's Centauro layout — one file per joint):
  python tools/csv2npz.py ... --joint-files 'CentAcESC_{}_log.txt' \
      --time-col 0 --pos-cols 8 --tau-cols 12
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from flobaroid_tpu.data import Data  # noqa: E402
from flobaroid_tpu.utils.cli import setup_jax  # noqa: E402
from flobaroid_tpu.utils.config import load_config  # noqa: E402


def parse_cols(spec: str):
    if ":" in spec:
        a, b = spec.split(":")
        return list(range(int(a), int(b)))
    return [int(v) for v in spec.split(",")]


def parse_floats(spec: str):
    return np.asarray([float(v) for v in spec.split(",")])


def main():
    # platform choice + persistent compile cache BEFORE any backend
    # initialization (the --resimulate-torques pass compiles the
    # regressor)
    setup_jax()
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("--config", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--regressor", default=None)
    p.add_argument("--csv", help="one combined CSV file")
    p.add_argument("--joint-files",
                   help="per-joint file pattern with {} for the 1-based joint "
                        "number (in a directory given by --csv-dir)")
    p.add_argument("--csv-dir", default=".")
    p.add_argument("--time-col", type=int, default=0)
    p.add_argument("--time-scale", type=float, default=1.0,
                   help="multiply raw time stamps (e.g. 1e-9 for ns)")
    p.add_argument("--pos-cols", required=True)
    p.add_argument("--vel-cols", default=None)
    p.add_argument("--tau-cols", required=True)
    p.add_argument("--target-pos-cols", default=None)
    p.add_argument("--joint-order", default=None,
                   help="CSV column index per URDF joint, comma separated")
    p.add_argument("--joint-signs", default=None,
                   help="per-URDF-joint sign corrections, comma separated")
    p.add_argument("--tau-offsets", default=None,
                   help="per-URDF-joint torque offsets subtracted after signs")
    p.add_argument("--resimulate-torques", action="store_true",
                   help="replace logged torques with model-simulated torques "
                        "along the recorded motion (gazebo mode)")
    p.add_argument("--delimiter", default=",",
                   help="use 'ws' for whitespace-separated files")
    p.add_argument("--skip-header", type=int, default=0)
    p.add_argument("--out", default="measurements.npz")
    args = p.parse_args()

    cfg = load_config(args.config)
    cfg["urdf"] = args.model

    pos_cols = parse_cols(args.pos_cols)
    tau_cols = parse_cols(args.tau_cols)

    if args.joint_files:
        # one file per joint: pos/tau column indices are scalars per file
        nd = len(pos_cols) if len(pos_cols) > 1 else None
        files, raws = [], []
        i = 1
        while True:
            fn = os.path.join(args.csv_dir, args.joint_files.format(i))
            if not os.path.exists(fn) or (nd and i > nd):
                break
            raws.append(np.loadtxt(fn))
            files.append(fn)
            i += 1
        if not raws:
            print(f"no files matched {args.joint_files} in {args.csv_dir}")
            return 1
        n = min(r.shape[0] for r in raws)
        t = raws[0][:n, args.time_col] * args.time_scale
        Q = np.stack([r[:n, pos_cols[0]] for r in raws], axis=1)
        Tau = np.stack([r[:n, tau_cols[0]] for r in raws], axis=1)
        Tgt = (
            np.stack([r[:n, parse_cols(args.target_pos_cols)[0]] for r in raws], axis=1)
            if args.target_pos_cols else None
        )
        V = None
    else:
        if not args.csv:
            print("either --csv or --joint-files is required")
            return 1
        delim = None if args.delimiter == "ws" else args.delimiter
        raw = np.genfromtxt(args.csv, delimiter=delim,
                            skip_header=args.skip_header)
        t = raw[:, args.time_col] * args.time_scale
        Q = raw[:, pos_cols]
        Tau = raw[:, tau_cols]
        V = raw[:, parse_cols(args.vel_cols)] if args.vel_cols else None
        Tgt = raw[:, parse_cols(args.target_pos_cols)] if args.target_pos_cols else None

    t = t - t[0]

    # CSV -> URDF joint reordering (reference csv_T_urdf_indices)
    if args.joint_order:
        order = [int(v) for v in args.joint_order.split(",")]
        Q = Q[:, order]
        Tau = Tau[:, order]
        if V is not None:
            V = V[:, order]
        if Tgt is not None:
            Tgt = Tgt[:, order]

    # per-joint sign + offset corrections (reference joint_signs path)
    if args.joint_signs:
        s = parse_floats(args.joint_signs)
        Q = Q * s
        Tau = Tau * s
        if V is not None:
            V = V * s
        if Tgt is not None:
            Tgt = Tgt * s
    if args.tau_offsets:
        Tau = Tau - parse_floats(args.tau_offsets)

    if V is None:
        V = np.gradient(Q, t, axis=0)
    freq = 1.0 / float(np.median(np.diff(t)))

    samples = {
        "positions": Q,
        "velocities": V,
        "accelerations": np.zeros_like(V),
        "torques": Tau,
        "times": t,
        "frequency": np.float64(freq),
    }
    if Tgt is not None:
        samples["target_positions"] = Tgt
    data = Data(cfg)
    data.init_from_data(samples)
    data.preprocess()

    if args.resimulate_torques:
        # gazebo mode: the recorded kinematics are trusted, the logged
        # torques are not — recompute them from the model (reference
        # tools/csv2npz.py:547-579)
        from flobaroid_tpu.model import Model

        sim_cfg = dict(cfg)
        sim_cfg.update(skipSamples=0, startOffset=0, simulateTorques=1)
        model = Model(sim_cfg, args.model, regressor_file=args.regressor,
                      regressor_init=False)
        n = data.samples["positions"].shape[0]
        sim = model.simulate_dynamics(data.samples, np.arange(n))
        data.samples["torques"] = sim[:, model.fb:]
        data.samples["torques_raw"] = data.samples["torques"].copy()
        print("replaced logged torques with model-simulated torques")

    np.savez(args.out, **data.samples)
    print(f"wrote {args.out}: {Q.shape[0]} samples at {freq:.1f} Hz, "
          f"{Q.shape[1]} joints")
    return 0


if __name__ == "__main__":
    sys.exit(main())
