"""Measurement data loading, preprocessing and block selection.

Counterpart of the reference's identification/data.py (Data class):
multi-file npz concatenation with time rebasing (data.py:55-146),
zero-phase Butterworth/median filtering + central-difference
differentiation (data.py:369-529), IMU-to-base-state processing
(data.py:531-606), near-zero-velocity sample removal (data.py:346-367)
and Venture-2009 condition-number block selection (data.py:205-344).

All of this is cheap offline host-side signal processing (scipy); the
device work starts after preprocessing with the batched regressor. The
npz measurement contract is byte-compatible (latin1 py2 legacy files
included).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import scipy.integrate
import scipy.signal

from .dynamics import spatial as sp_alg

REQUIRED_KEYS = ("positions", "velocities", "accelerations", "torques", "times", "frequency")


def central_diff(array: np.ndarray, times: np.ndarray, n: int = 2) -> np.ndarray:
    """Central differences matching the reference's 2nd-order 5-point
    scheme (reference: identification/data.py:395-418)."""
    div = times[1] - times[0]
    size = len(array)
    diff = np.zeros_like(array)
    if n == 1:
        diff[0] = (array[1] - array[0]) / div
        for i in range(1, size - 1):
            d = times[i] - times[i - 1]
            diff[i] = (array[i + 1] - array[i - 1]) / (2 * d)
        diff[-1] = (array[-1] - array[-2]) / div
    elif n == 2:
        diff[0] = (array[1] - array[0]) / div
        diff[1] = (array[2] - array[0]) / (2 * div)
        # vectorized inner 5-point stencil with per-sample step
        if size > 4:
            d = (times[2 : size - 2] - times[1 : size - 3])[:, None] if array.ndim > 1 else (
                times[2 : size - 2] - times[1 : size - 3]
            )
            diff[2 : size - 2] = (
                -array[4:size] + 8 * array[3 : size - 1] - 8 * array[1 : size - 3] + array[0 : size - 4]
            ) / (12 * d)
        diff[size - 2] = (array[size - 1] - array[size - 3]) / (2 * div)
        diff[size - 1] = (array[size - 1] - array[size - 2]) / div
    else:
        raise ValueError("use n = 1 or 2")
    return diff


class Data:
    def __init__(self, opt: dict[str, Any]):
        self.opt = opt
        self.measurements: dict[str, Any] = {}
        self.samples: dict[str, Any] = {}
        self.file_boundaries: list[int] = [0]
        self.num_loaded_samples = 0
        self.num_used_samples = 0
        self.inited = False
        # set by Model.computeRegressors after it writes the contact
        # contribution into the base-wrench torque rows (guards a second
        # pass over the same Data from adding contacts twice)
        self.contacts_in_torques = False
        # block selection state
        self.block_pos = 0
        self.blocks: list[dict] = []
        self.selected_blocks: list[int] = []

    # ------------------------------------------------------------------
    def init_from_files(self, measurements_files) -> None:
        """Concatenate repeated --measurements npz files with time-axis
        rebasing, startOffset skipping and latin1 py2 compatibility
        (reference: identification/data.py:55-146)."""
        so = int(self.opt["startOffset"])
        if measurements_files and isinstance(measurements_files[0], str):
            measurements_files = [measurements_files]
        self.file_boundaries = [0]
        for group in measurements_files:
            for fn in group:
                with open(fn, "rb") as fh:
                    head = fh.read(64)
                if head.startswith(b"version https://git-lfs"):
                    raise OSError(
                        f"{fn} is a git-lfs pointer stub, not real data — "
                        f"fetch it with 'git lfs pull' in the source repository"
                    )
                m = np.load(fn, encoding="latin1", allow_pickle=True)
                n_new = m["positions"].shape[0] - so
                self.file_boundaries.append(self.file_boundaries[-1] + n_new)
                for k in m.files:
                    v = m[k]
                    if k not in self.measurements:
                        if v.ndim == 0:
                            if isinstance(v.item(0), dict):
                                cd = {
                                    c: v.item(0)[c][so:, :]
                                    for c in v.item(0)
                                    if c != "dummy_sim"
                                }
                                self.measurements[k] = np.array(cd)
                            else:
                                self.measurements[k] = v
                        elif v.ndim == 1:
                            self.measurements[k] = v[so:]
                        else:
                            self.measurements[k] = v[so:, :]
                    else:
                        if v.ndim == 0:
                            if isinstance(v.item(0), dict):
                                old = self.measurements[k].item(0)
                                cd = {}
                                for c in v.item(0):
                                    if c == "dummy_sim":
                                        continue
                                    cd[c] = np.concatenate((old[c], v.item(0)[c][so:, :]))
                                self.measurements[k] = np.array(cd)
                            # scalars: keep first file's value
                        elif v.ndim == 1:
                            vv = v
                            if k == "times":
                                vv = v - v[so] + (v[so + 1] - v[so])
                                vv = vv + self.measurements[k][-1]
                            self.measurements[k] = np.concatenate(
                                (self.measurements[k], vv[so:])
                            )
                        else:
                            self.measurements[k] = np.concatenate(
                                (self.measurements[k], v[so:, :])
                            )
                m.close()
        missing = [k for k in REQUIRED_KEYS if k not in self.measurements]
        if missing:
            raise KeyError(f"measurements missing required keys: {missing}")
        self._use_all()
        self.inited = True

    def init_from_data(self, samples: dict[str, Any]) -> None:
        """Initialize directly from an in-memory samples dict (used by the
        simulator and synthetic tests; reference: data.py init_from_data)."""
        self.measurements = dict(samples)
        self.file_boundaries = [0, samples["positions"].shape[0]]
        self._use_all()
        self.inited = True

    def _use_all(self) -> None:
        self.samples = self.measurements
        self.contacts_in_torques = False  # fresh measurement torques
        self.num_loaded_samples = self.measurements["positions"].shape[0]
        self.num_used_samples = self.num_loaded_samples // (int(self.opt["skipSamples"]) + 1)

    # ------------------------------------------------------------------
    def preprocess(self, imu: bool = False) -> None:
        """Filter + differentiate the loaded samples in place: positions
        low-passed; velocities from central differences of filtered
        positions (median + low-pass); accelerations from velocity
        differences (median); torques median + low-passed; optional IMU
        processing into base_* arrays (reference: data.py:369-619)."""
        s = self.samples
        opt = self.opt
        Fs = float(s["frequency"])
        T = s["times"]
        n_dofs = s["positions"].shape[1]
        med = int(opt["filterMedianSize"])

        if opt["useDeg"]:
            s["positions"] = np.deg2rad(s["positions"])
            s["velocities"] = np.deg2rad(s["velocities"])

        def butter(lp):
            fc, order = float(lp[0]), int(lp[1])
            return scipy.signal.butter(order, fc / (Fs / 2), btype="low", analog=False)

        b8, a8 = butter(opt["filterLowPass1"])
        b6, a6 = butter(opt["filterLowPass2"])
        b3, a3 = butter(opt["filterLowPass3"])

        def lp(arr, b, a):
            return scipy.signal.filtfilt(b, a, arr, axis=0)

        def medf(arr):
            return scipy.signal.medfilt(arr, [med, 1])

        Q = np.asarray(s["positions"], dtype=float)
        s["positions_raw"] = Q.copy()
        Q = lp(Q, b8, a8)
        s["positions"] = Q

        V = central_diff(Q, T, 2)
        s["velocities_raw"] = V.copy()
        V = lp(medf(V), b6, a6)
        s["velocities"] = V

        A = medf(central_diff(V, T, 2))
        s["accelerations"] = A

        Tau = np.asarray(s["torques"], dtype=float)
        s["torques_raw"] = Tau.copy()
        s["torques"] = lp(medf(Tau), b8, a8)

        if imu and "IMUlinAcc" in s and "IMUrotVel" in s:
            self._process_imu(s, T, (b8, a8), (b3, a3), med)

        if "contacts" in s and s["contacts"].ndim == 0:
            cd = s["contacts"].item(0)
            for c in cd:
                w = np.asarray(cd[c], dtype=float)
                w = scipy.signal.medfilt(w, [med, 1])
                cd[c] = lp(w, b3, a3)

        # invalidate cached derived series
        s.pop("velocities_for_sign", None)
        s.pop("friction_sign_series", None)

    def _process_imu(self, s, T, f8, f3, med) -> None:
        """IMU -> base velocity/acceleration/rpy (reference: data.py:531-606)."""
        b8, a8 = f8
        b3, a3 = f3
        lin_acc = scipy.signal.medfilt(np.asarray(s["IMUlinAcc"], float), [med, 1])
        rot_vel = scipy.signal.medfilt(np.asarray(s["IMUrotVel"], float), [med, 1])
        lin_acc = scipy.signal.filtfilt(b8, a8, lin_acc, axis=0)
        rot_vel = scipy.signal.filtfilt(b8, a8, rot_vel, axis=0)
        rpy = scipy.signal.filtfilt(b3, a3, np.asarray(s["IMUrpy"], float), axis=0)

        # rotate to world using the stored rpy convention (R = RPY(rpy))
        import numpy as _np

        R = _np.asarray(sp_alg.rpy_to_rot(rpy))
        lin_acc_w = _np.einsum("nij,nj->ni", R, lin_acc)
        rot_vel_w = _np.einsum("nij,nj->ni", R, rot_vel)

        grav_norm = _np.mean(_np.linalg.norm(lin_acc_w, axis=1))
        if grav_norm < 9.81 or grav_norm > 9.82:
            print(f"Warning: mean base acceleration differs from gravity ({grav_norm})!")
        # reference-parity gravity handling (reference data.py:570): the
        # constant is later removed again by the unconditional mean
        # subtraction below ("includes wrong gravity offset and other
        # static offsets" per the reference's own comment) — kept for
        # behavioral parity, the mean removal is what actually matters
        lin_acc_w -= _np.array([0, 0, -9.81])

        if self.opt["waitForZeroAcc"]:
            means = _np.mean(lin_acc_w, axis=0)
            centered = lin_acc_w - means
            start = 0
            for j in range(3):
                for k in range(centered.shape[0]):
                    if _np.linalg.norm(centered[k : k + 10, j]) < self.opt["zeroAccThresh"]:
                        start = max(k, start)
                        break
            centered[:start, :] = 0
            lin_acc_w = centered + means
        lin_acc_w -= _np.mean(lin_acc_w, axis=0)

        lin_vel = _np.stack(
            [
                scipy.integrate.cumulative_trapezoid(lin_acc_w[:, j], T, initial=0)
                for j in range(3)
            ],
            axis=1,
        )
        lin_vel -= _np.mean(lin_vel, axis=0)
        # differentiate w.r.t. TIME: the reference passes no sample
        # coordinates to np.gradient (data.py:606), scaling rotational
        # acceleration by dt (~1/fs, 200x too small at 200 Hz) — a
        # reference bug, fixed here
        rot_acc = _np.stack(
            [_np.gradient(rot_vel_w[:, j], T) for j in range(3)], axis=1
        )

        # base_rpy must be stored in the npz INVERSE convention
        # world_R_base = RPY(rpy)^T (reference
        # suspendedDynamics.py:176-182, consumed at model.py:273-275).
        # IMUrpy is the orientation estimate in the DIRECT convention
        # (world_R_imu = RPY(IMUrpy) — that is the rotation used to map
        # the readings to world above); writing it through unconverted,
        # as the reference does (data.py:595), hands the estimator the
        # TRANSPOSED base rotation. Convert here: rpy_storage =
        # rot_to_rpy(R^T). (First-order small for a near-level torso,
        # which is why it survived on real data; caught by the walking-
        # scenario IMU loop test, round 4.)
        import jax as _jax

        R_T = _np.swapaxes(R, 1, 2)
        rpy_storage = _np.asarray(
            _jax.vmap(sp_alg.rot_to_rpy)(_np.ascontiguousarray(R_T))
        )
        s["base_rpy"] = rpy_storage
        s["base_velocity"] = _np.concatenate([lin_vel, rot_vel_w], axis=1)
        s["base_acceleration"] = _np.concatenate([lin_acc_w, rot_acc], axis=1)

    # ------------------------------------------------------------------
    def remove_near_zero_samples(self) -> None:
        """Drop samples where all joints move slower than minVel
        (reference: data.py:346-367)."""
        v = np.abs(np.asarray(self.samples["velocities"]))
        keep = np.any(v > float(self.opt["minVel"]), axis=1)
        n = self.samples["positions"].shape[0]
        for k, val in list(self.samples.items()):
            arr = np.asarray(val)
            if arr.ndim >= 1 and arr.shape[0] == n and arr.dtype != object:
                self.samples[k] = arr[keep]
            elif arr.ndim == 0 and isinstance(val.item(0) if hasattr(val, "item") else None, dict):
                cd = val.item(0)
                self.samples[k] = np.array({c: cd[c][keep] for c in cd})
        self.num_loaded_samples = int(np.sum(keep))
        self.num_used_samples = self.num_loaded_samples // (int(self.opt["skipSamples"]) + 1)

    # ------------------------------------------------------------------
    # block selection (Venture 2009; reference data.py:205-344)
    # ------------------------------------------------------------------
    def num_blocks(self) -> int:
        bs = int(self.opt["blockSize"])
        return max(1, self.measurements["positions"].shape[0] // bs)

    def select_blocks(self, score_fn: Callable[[dict], float]) -> None:
        """Split the loaded measurements into blocks of `blockSize`
        samples, score each via score_fn (lower is better; the reference
        uses the base-regressor condition number), keep the best
        `selectBestPerenctage` percent and reassemble with rebased time."""
        bs = int(self.opt["blockSize"])
        n_blocks = self.num_blocks()
        scores = []
        for b in range(n_blocks):
            sub = self._slice(self.measurements, b * bs, (b + 1) * bs)
            scores.append(score_fn(sub))
        self.select_blocks_from_stats(np.asarray(scores, dtype=float))

    def select_blocks_from_stats(
        self,
        conds,
        link_conds=None,
        grams=None,
    ) -> None:
        """Venture-2009 block selection from precomputed per-block stats
        (reference data.py:205-344 + identifier.py:1564-1589):

        1. keep blocks at/below the `selectBestPerenctage` percentile of
           base-regressor condition numbers (data.py:258-262),
        2. drop blocks whose per-link subregressor-cond variance pattern
           near-duplicates a kept one (<15% apart, data.py:282-311),
        3. greedy keep-if-improves pass: re-admit unused blocks (in
           cond order) whenever they IMPROVE the conditioning of the
           assembled selection — evaluated exactly from the per-block
           base Grams (cond2(Y_union) = sqrt(cond2(sum G_b))).
        """
        conds = np.asarray(conds, dtype=float)
        n_blocks = len(conds)
        perc = np.percentile(conds, float(self.opt["selectBestPerenctage"]))
        used = [b for b in range(n_blocks) if conds[b] <= perc]
        unused = [b for b in range(n_blocks) if b not in used]
        if self.opt.get("verbose"):
            for b in unused:
                print(f"not using block {b} (cond {conds[b]:.3g})")

        # Near-duplicate variance-pattern pruning, behavior-parity with
        # the reference (data.py:282-311): blocks are ordered by the
        # variance of their per-link condition pattern; inside a run of
        # near-equal values (<15% relative) the middle of a close triple
        # is redundant, and for a close pair the earlier one is. Exact
        # decision parity matters here — it determines which measurement
        # blocks enter the assembled regressor.
        if link_conds is not None and len(used) > 2:
            lc = np.asarray([link_conds[b] for b in used], dtype=float)
            pattern_var = np.var(np.where(np.isfinite(lc), lc, 0.0), axis=1)
            order = np.argsort(pattern_var)
            v = pattern_var[order]
            rel_close = lambda a, b: abs(a - b) < abs(b) * 0.15
            drop_pos: list[int] = []
            i, n_used = 1, len(used)
            while i < n_used:
                if i + 1 < n_used and rel_close(v[i - 1], v[i + 1]):
                    # close triple: outer pair stays, middle goes
                    drop_pos.append(order[i])
                    i += 2
                    continue
                if rel_close(v[i - 1], v[i]):
                    drop_pos.append(order[i - 1])
                i += 1
            dropped = {used[d] for d in drop_pos}
            if dropped and self.opt.get("verbose"):
                print(f"dropping near-duplicate blocks {sorted(dropped)}")
            unused = sorted(set(unused) | dropped)
            used = [b for b in used if b not in dropped]

        # greedy keep-if-improves refinement on exact union conditioning
        if grams is not None and used:
            def union_cond(sel):
                G = np.sum([grams[b] for b in sel], axis=0)
                ev = np.linalg.eigvalsh(G)
                return np.inf if ev[0] <= 0 else float(np.sqrt(ev[-1] / ev[0]))

            cur = union_cond(used)
            for b in sorted(unused, key=lambda b: conds[b]):
                cand = union_cond(used + [b])
                if cand < cur:
                    used.append(b)
                    cur = cand
                    if self.opt.get("verbose"):
                        print(f"re-admitting block {b}: union cond -> {cur:.3g}")

        self.selected_blocks = sorted(used) or [int(np.argmin(conds))]
        self.assemble_selected_blocks()

    def assemble_selected_blocks(self) -> None:
        bs = int(self.opt["blockSize"])
        parts = [self._slice(self.measurements, b * bs, (b + 1) * bs) for b in self.selected_blocks]
        out: dict[str, Any] = {}
        for k, v in self.measurements.items():
            arr = np.asarray(v)
            if arr.ndim == 0:
                if hasattr(v, "item") and isinstance(v.item(0), dict):
                    cd = v.item(0)
                    out[k] = np.array(
                        {c: np.concatenate([p[k].item(0)[c] for p in parts]) for c in cd}
                    )
                else:
                    out[k] = v
            elif k == "times":
                t = []
                offset = 0.0
                for p in parts:
                    tt = p[k] - p[k][0] + offset
                    dt = p[k][1] - p[k][0] if len(p[k]) > 1 else 0.0
                    t.append(tt)
                    offset = tt[-1] + dt
                out[k] = np.concatenate(t)
            else:
                out[k] = np.concatenate([p[k] for p in parts])
        self.samples = out
        self.num_loaded_samples = out["positions"].shape[0]
        self.num_used_samples = self.num_loaded_samples // (int(self.opt["skipSamples"]) + 1)

    @staticmethod
    def _slice(meas: dict, lo: int, hi: int) -> dict:
        n = meas["positions"].shape[0]
        out = {}
        for k, v in meas.items():
            arr = np.asarray(v)
            if arr.ndim == 0:
                if hasattr(v, "item") and isinstance(v.item(0), dict):
                    cd = v.item(0)
                    out[k] = np.array({c: cd[c][lo:hi] for c in cd})
                else:
                    out[k] = v
            elif arr.shape[0] == n:
                out[k] = arr[lo:hi]
            else:
                out[k] = v
        return out


def save_measurements(filename: str, samples: dict[str, Any]) -> None:
    """Write a measurements npz preserving the reference key contract
    (reference: simulator.py:298-317, excite.py:129-150)."""
    np.savez(filename, **samples)
