"""Reference-equation oracles in plain numpy (float64, growing state).

These re-derive the C++ filter math of the reference (ekf.cpp / ukf.cpp /
filter.h) directly from the equations, including its quirks, to serve as golden
implementations for parity tests of the padded fixed-capacity filters.
They intentionally mirror behavior, not code structure.
"""

from __future__ import annotations

import math

import numpy as np


def wrap(t):
    return math.remainder(t, 2 * math.pi)


class EKFOracle:
    """EKF-SLAM per ekf.cpp with a dynamically growing state.

    Quirk flags mirror config.CompatConfig: `stale_landmarks` reads landmark
    positions from the committed x_t (ekf.cpp:115-129), `unwrapped_innovation`
    leaves nu(1)=b-ang unwrapped (ekf.cpp:131). V/W values passed in should
    already reflect the noise_vw_swap if desired.
    """

    def __init__(
        self,
        x0, y0, yaw0,
        V=(0.01, 0.001),
        W=(0.01, 0.01),
        v_mean=(0.0, 0.0),
        w_mean=(0.0, 0.0),
        id_known=True,
        min_sep=0.1,
        stale_landmarks=True,
        unwrapped_innovation=True,
    ):
        self.x_t = np.array([x0, y0, yaw0], dtype=np.float64)
        self.P_t = np.diag([0.01**2, 0.01**2, 0.005**2]).astype(np.float64)
        self.V = np.diag(V).astype(np.float64)
        self.W = np.diag(W).astype(np.float64)
        self.v_d, self.v_th = v_mean
        self.w_r, self.w_b = w_mean
        self.id_known = id_known
        self.min_sep = min_sep
        self.stale = stale_landmarks
        self.unwrapped = unwrapped_innovation
        self.lm_ids: list[int] = []
        self.M = 0

    def update(self, cmd, meas):
        """cmd = (fwd, ang); meas = [(id, r, b), ...] in emission order."""
        d_d, d_th = cmd
        n = 3 + 2 * self.M
        th = self.x_t[2]
        F_x = np.eye(n)
        F_x[0, 2] = -d_d * math.sin(th)
        F_x[1, 2] = d_d * math.cos(th)
        F_v = np.zeros((n, 2))
        F_v[0, 0] = math.cos(th)
        F_v[1, 0] = math.sin(th)
        F_v[2, 1] = 1.0
        x_pred = self.x_t.copy()
        x_pred[0] = self.x_t[0] + (d_d + self.v_d) * math.cos(th)
        x_pred[1] = self.x_t[1] + (d_d + self.v_d) * math.sin(th)
        x_pred[2] = wrap(th + d_th + self.v_th)
        P_pred = F_x @ self.P_t @ F_x.T + F_v @ self.V @ F_v.T

        for (mid, r, b) in meas:
            i = -1
            if not self.id_known:
                mid = self.M
                xd = x_pred[0] + r * math.cos(x_pred[2] + b)
                yd = x_pred[1] + r * math.sin(x_pred[2] + b)
                for j in range(self.M):
                    if (
                        abs(xd - x_pred[3 + 2 * j]) < self.min_sep
                        and abs(yd - x_pred[3 + 2 * j + 1]) < self.min_sep
                    ):
                        i = j
                        mid = j
                        break
            else:
                for j in range(self.M):
                    if self.lm_ids[j] == mid:
                        i = j
                        break
            if i != -1:
                li = i * 2 + 3
                src = self.x_t if self.stale else x_pred
                lmx, lmy = src[li], src[li + 1]
                ddx = lmx - x_pred[0]
                ddy = lmy - x_pred[1]
                dist = math.sqrt(ddx * ddx + ddy * ddy)
                n_cur = 3 + 2 * self.M
                H = np.zeros((2, n_cur))
                H[0, 0] = -ddx / dist
                H[0, 1] = -ddy / dist
                H[1, 0] = ddy / dist**2
                H[1, 1] = -ddx / dist**2
                H[1, 2] = -1.0
                H[0, li] = ddx / dist
                H[0, li + 1] = ddy / dist
                H[1, li] = -ddy / dist**2
                H[1, li + 1] = ddx / dist**2
                ang = wrap(math.atan2(ddy, ddx) - x_pred[2])
                nu = np.array(
                    [r - dist - self.w_r, b - ang - self.w_b], dtype=np.float64
                )
                if not self.unwrapped:
                    nu[1] = wrap(nu[1])
                S = H @ P_pred @ H.T + self.W
                K = P_pred @ H.T @ np.linalg.inv(S)
                x_pred = x_pred + K @ nu
                x_pred[2] = wrap(x_pred[2])
                P_pred = P_pred - K @ H @ P_pred
            else:
                self.M += 1
                n_new = 3 + 2 * self.M
                x_new = np.zeros(n_new)
                x_new[: n_new - 2] = x_pred
                tb = x_pred[2] + b
                x_new[n_new - 2] = x_pred[0] + r * math.cos(tb)
                x_new[n_new - 1] = x_pred[1] + r * math.sin(tb)
                x_pred = x_new
                self.lm_ids.append(int(mid))
                Y = np.eye(n_new)
                Y[n_new - 2, n_new - 2] = math.cos(tb)
                Y[n_new - 2, n_new - 1] = -r * math.sin(tb)
                Y[n_new - 1, n_new - 2] = math.sin(tb)
                Y[n_new - 1, n_new - 1] = r * math.cos(tb)
                Y[n_new - 2, 0] = 1.0
                Y[n_new - 2, 2] = -r * math.sin(tb)
                Y[n_new - 1, 1] = 1.0
                Y[n_new - 1, 2] = r * math.cos(tb)
                p_temp = np.zeros((n_new, n_new))
                p_temp[: n_new - 2, : n_new - 2] = P_pred
                p_temp[n_new - 2:, n_new - 2:] = self.W
                P_pred = Y @ p_temp @ Y.T
        self.x_t = x_pred
        self.P_t = P_pred


class UKFOracle:
    """UKF per ukf.cpp (SLAM or localization-only), growing 4+2M state.

    Quirks: `zero_bearing_mean` (ukf.cpp:310-314), `committed_yaw` in the
    sensing model (ukf.cpp:139).
    """

    def __init__(
        self,
        x0, y0, yaw0,
        V=(0.01, 0.001),
        W=(0.01, 0.01),
        v_mean=(0.0, 0.0),
        w_mean=(0.0, 0.0),
        W_0=0.2,
        slam=True,
        true_map=None,
        zero_bearing_mean=True,
        committed_yaw=True,
        signed_q=True,
    ):
        self.x_t = np.array(
            [x0, y0, math.cos(yaw0), math.sin(yaw0)], dtype=np.float64
        )
        self.P_t = np.diag([0.01**2, 0.01**2, 0.005**2, 0.005**2])
        self.V = np.diag(V).astype(np.float64)
        self.W = np.diag(W).astype(np.float64)
        self.v_d, self.v_th = v_mean
        self.w_r, self.w_b = w_mean
        self.W0 = W_0
        self.slam = slam
        self.true_map = true_map  # (N, 2) by id, loc mode
        self.zero_bearing_mean = zero_bearing_mean
        self.committed_yaw = committed_yaw
        self.signed_q = signed_q
        self.lm_ids: list[int] = []
        self.M = 0

    def _yaw(self, x):
        return wrap(math.atan2(x[3], x[2]))

    def _nearest_spd_sqrt(self, P, n):
        Y = 0.5 * (P + P.T) * (n / (1.0 - self.W0))
        d, Q = np.linalg.eigh(Y)
        d = np.maximum(d, 1e-8)
        return (Q * np.sqrt(d)[None, :]) @ Q.T

    def _motion(self, x, u_d, u_th):
        out = x.copy()
        yaw = self._yaw(x)
        out[0] = x[0] + (u_d + self.v_d) * math.cos(yaw)
        out[1] = x[1] + (u_d + self.v_d) * math.sin(yaw)
        ny = wrap(yaw + u_th + self.v_th)
        out[2] = math.cos(ny)
        out[3] = math.sin(ny)
        return out

    def _sense(self, x, lm_i, committed_yaw_val):
        if self.committed_yaw:
            yaw = committed_yaw_val
        else:
            yaw = self._yaw(x)
        if self.slam:
            lx, ly = x[lm_i], x[lm_i + 1]
        else:
            lx, ly = self.true_map[lm_i]
        dx, dy = lx - x[0], ly - x[1]
        zr = math.sqrt(dx * dx + dy * dy) + self.w_r
        zb = wrap(math.atan2(dy, dx) - yaw + self.w_b)
        return np.array([zr, zb])

    def update(self, cmd, meas):
        u_d, u_th = cmd
        n = 2 * self.M + 4
        yaw = self._yaw(self.x_t)
        Q = np.zeros((n, n))
        c, si = math.cos(yaw), math.sin(yaw)
        if self.signed_q:
            # reference quirk (ukf.cpp:182-186): signed diag
            Q[0, 0] = self.V[0, 0] * c
            Q[1, 1] = self.V[0, 0] * si
            Q[2, 2] = self.V[1, 1] * c
            Q[3, 3] = self.V[1, 1] * si
        else:
            # corrected PSD projection Q = G V G^T
            Q[0, 0] = self.V[0, 0] * c * c
            Q[0, 1] = Q[1, 0] = self.V[0, 0] * c * si
            Q[1, 1] = self.V[0, 0] * si * si
            Q[2, 2] = self.V[1, 1] * si * si
            Q[2, 3] = Q[3, 2] = -self.V[1, 1] * c * si
            Q[3, 3] = self.V[1, 1] * c * c

        # prediction
        sqtP = self._nearest_spd_sqrt(self.P_t, n)
        X = np.zeros((n, 2 * n + 1))
        X[:, 0] = self.x_t
        for i in range(1, n + 1):
            X[:, i] = self.x_t + sqtP[:, i - 1]
            X[:, i + n] = self.x_t - sqtP[:, i - 1]
        wts = np.full(2 * n + 1, (1 - self.W0) / (2 * n))
        wts[0] = self.W0
        X_pred = np.zeros_like(X)
        for i in range(2 * n + 1):
            X_pred[:, i] = self._motion(X[:, i], u_d, u_th)
        x_pred = X_pred @ wts
        dev = X_pred - x_pred[:, None]
        P_pred = (dev * wts[None, :]) @ dev.T + Q

        committed_yaw_val = yaw

        # update stage: all known-landmark updates first, insertions last
        inserts = []
        for (mid, r, b) in meas:
            lm_i = -1
            if self.slam:
                for j in range(self.M):
                    if self.lm_ids[j] == mid:
                        lm_i = j
                        break
                if lm_i == -1:
                    inserts.append((mid, r, b))
                    continue
                li = lm_i * 2 + 4
            else:
                li = int(mid)
            n_cur = 2 * self.M + 4
            X_zest = np.zeros((2, 2 * n_cur + 1))
            for i in range(2 * n_cur + 1):
                X_zest[:, i] = self._sense(X_pred[:, i], li, committed_yaw_val)
            z_est = np.zeros(2)
            if self.zero_bearing_mean:
                z_est[0] = X_zest[0] @ wts
            else:
                z_est[0] = X_zest[0] @ wts
                z_est[1] = math.atan2(
                    np.sin(X_zest[1]) @ wts, np.cos(X_zest[1]) @ wts
                )
            S = np.zeros((2, 2))
            for i in range(2 * n_cur + 1):
                diff = X_zest[:, i] - z_est
                diff[1] = wrap(diff[1])
                S += wts[i] * np.outer(diff, diff)
            S += self.W
            C = np.zeros((n_cur, 2))
            for i in range(2 * n_cur + 1):
                dx = X_pred[:, i] - x_pred
                d2 = X_zest[:, i] - z_est
                d2[1] = wrap(d2[1])
                C += wts[i] * np.outer(dx, d2)
            K = C @ np.linalg.inv(S)
            innov = np.array([r, b]) - z_est
            innov[1] = wrap(innov[1])
            x_pred = x_pred + K @ innov
            P_pred = P_pred - K @ S @ K.T

        for (mid, r, b) in inserts:
            n_cur = 2 * self.M + 4
            yaw_p = wrap(math.atan2(x_pred[3], x_pred[2]))
            x_new = np.zeros(n_cur + 2)
            x_new[:n_cur] = x_pred
            x_new[n_cur] = x_pred[0] + r * math.cos(yaw_p + b)
            x_new[n_cur + 1] = x_pred[1] + r * math.sin(yaw_p + b)
            x_pred = x_new
            self.lm_ids.append(int(mid))
            p_tmp = np.eye(n_cur + 2)
            p_tmp[:n_cur, :n_cur] = P_pred
            p_tmp[n_cur:, n_cur:] = self.W
            P_pred = p_tmp
            self.M += 1

        self.x_t = x_pred
        self.P_t = P_pred

    def pose(self):
        return np.array(
            [self.x_t[0], self.x_t[1], self._yaw(self.x_t)]
        )
