"""Full Lie-group surface: SO3 / SE3 / RxSO3 / Sim3 (the Sophus role).

The reference vendors all of Sophus (submodules/Sophus/sophus/{so3,se3,
rxso3,sim3}.hpp) though its mapping path only ever constructs SE3d
(gaussian_keyframe.h:58-59, gaussian_mapper.h:130). The full surface
matters when an external tracker feeds Sim(3) loop-closure corrections
(scale-drifting monocular SLAM): poses and map points are corrected by a
similarity, not a rigid transform. This module (a copy of
`gsdf_slam_tpu/utils/lie.py`) provides that surface as host-side float64
NumPy classes (poses live on the host; device code
consumes baked matrices), mirroring Sophus semantics:

- tangent orderings match Sophus: SE3 = (upsilon, omega) with the
  translational part FIRST (se3.hpp `exp`), Sim3 = (upsilon, omega, sigma)
  (sim3.hpp `exp`), RxSO3 = (omega, sigma) (rxso3.hpp).
- Sim3 exp uses the generalized left Jacobian W(omega, sigma) of
  sim_details.hpp `calcW` (A*Omega + B*Omega^2 + C*I with the same branch
  structure); log inverts W numerically instead of transcribing calcWInv
  (float64 + well-conditioned W make solve() exact to ~1e-12 here).
- `interpolate(a, b, t) = a * exp(t * log(a^-1 * b))` as in
  sophus/interpolate.hpp.

Quaternions are wxyz (Eigen/Sophus storage prints xyzw but the keyframe
API here, like the rest of the repo, is wxyz — see utils/coordinates.py).
"""

from __future__ import annotations

import numpy as np

from .se3 import hat, se3_exp, se3_log, so3_exp, so3_log

_EPS = 1e-10


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = np.asarray(q, np.float64)
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n < _EPS else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ]
    )


def _rot_to_quat(r: np.ndarray) -> np.ndarray:
    r = np.asarray(r, np.float64)
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2.0
        q = np.array(
            [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
             (r[1, 0] - r[0, 1]) / s]
        )
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(r[i, i] - r[j, j] - r[k, k] + 1.0, 0.0)) * 2.0
        q = np.empty(4)
        q[0] = (r[k, j] - r[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (r[j, i] + r[i, j]) / s
        q[1 + k] = (r[k, i] + r[i, k]) / s
    # canonicalize the double cover to w >= 0 (deterministic roundtrips)
    return q if q[0] >= 0 else -q


class SO3:
    """Rotation group (sophus/so3.hpp)."""

    def __init__(self, matrix: np.ndarray | None = None):
        self._r = np.eye(3) if matrix is None else np.asarray(matrix, np.float64)

    @staticmethod
    def exp(omega: np.ndarray) -> "SO3":
        return SO3(so3_exp(omega))

    @staticmethod
    def from_quaternion(q_wxyz: np.ndarray) -> "SO3":
        return SO3(_quat_to_rot(q_wxyz))

    def log(self) -> np.ndarray:
        return so3_log(self._r)

    def inverse(self) -> "SO3":
        return SO3(self._r.T)

    def matrix(self) -> np.ndarray:
        return self._r.copy()

    def quaternion(self) -> np.ndarray:
        return _rot_to_quat(self._r)

    def act(self, points: np.ndarray) -> np.ndarray:
        return np.asarray(points, np.float64) @ self._r.T

    def __mul__(self, other: "SO3") -> "SO3":
        return SO3(self._r @ other._r)

    def __repr__(self):
        return f"SO3(quat_wxyz={self.quaternion()})"


class SE3:
    """Rigid transform group (sophus/se3.hpp). Tangent = (upsilon, omega)."""

    DoF = 6

    def __init__(self, rotation: SO3 | np.ndarray | None = None,
                 translation: np.ndarray | None = None):
        if isinstance(rotation, np.ndarray) and rotation.shape == (4, 4):
            self._r = rotation[:3, :3].astype(np.float64)
            self._t = rotation[:3, 3].astype(np.float64)
            return
        if isinstance(rotation, SO3):
            self._r = rotation.matrix()
        elif rotation is None:
            self._r = np.eye(3)
        else:
            self._r = np.asarray(rotation, np.float64)
        self._t = (np.zeros(3) if translation is None
                   else np.asarray(translation, np.float64))

    @staticmethod
    def exp(xi: np.ndarray) -> "SE3":
        return SE3(se3_exp(xi))

    @staticmethod
    def from_quat_trans(q_wxyz: np.ndarray, t: np.ndarray) -> "SE3":
        """The GaussianKeyframe setPose path (gaussian_keyframe.cpp:39-52)."""
        return SE3(SO3.from_quaternion(q_wxyz), t)

    def log(self) -> np.ndarray:
        return se3_log(self.matrix())

    def inverse(self) -> "SE3":
        rt = self._r.T
        return SE3(rt, -rt @ self._t)

    def matrix(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = self._r
        m[:3, 3] = self._t
        return m

    def so3(self) -> SO3:
        return SO3(self._r)

    @property
    def translation(self) -> np.ndarray:
        return self._t.copy()

    def quaternion(self) -> np.ndarray:
        return _rot_to_quat(self._r)

    def act(self, points: np.ndarray) -> np.ndarray:
        return np.asarray(points, np.float64) @ self._r.T + self._t

    def __mul__(self, other: "SE3") -> "SE3":
        return SE3(self._r @ other._r, self._r @ other._t + self._t)

    def __repr__(self):
        return f"SE3(quat_wxyz={self.quaternion()}, t={self._t})"


def _calc_w(omega: np.ndarray, theta: float, sigma: float) -> np.ndarray:
    """Generalized left Jacobian, branch-for-branch with
    sophus/sim_details.hpp calcW (A*Omega + B*Omega^2 + C*I)."""
    k = hat(omega)
    k2 = k @ k
    scale = np.exp(sigma)
    if abs(sigma) < _EPS:
        c = 1.0
        if abs(theta) < _EPS:
            a, b = 0.5, 1.0 / 6.0
        else:
            th2 = theta * theta
            a = (1.0 - np.cos(theta)) / th2
            b = (theta - np.sin(theta)) / (th2 * theta)
    else:
        c = (scale - 1.0) / sigma
        if abs(theta) < _EPS:
            s2 = sigma * sigma
            a = ((sigma - 1.0) * scale + 1.0) / s2
            b = (scale * 0.5 * s2 + scale - 1.0 - sigma * scale) / (s2 * sigma)
        else:
            th2 = theta * theta
            sa = scale * np.sin(theta)
            sb = scale * np.cos(theta)
            cc = th2 + sigma * sigma
            a = (sa * sigma + (1.0 - sb) * theta) / (theta * cc)
            b = (c - ((sb - 1.0) * sigma + sa * theta) / cc) / th2
    return a * k + b * k2 + c * np.eye(3)


class RxSO3:
    """Rotation-and-scale group (sophus/rxso3.hpp). Tangent = (omega, sigma)."""

    def __init__(self, scale: float = 1.0, rotation: SO3 | None = None):
        self._s = float(scale)
        self._rot = rotation if rotation is not None else SO3()

    @staticmethod
    def exp(tangent: np.ndarray) -> "RxSO3":
        tangent = np.asarray(tangent, np.float64)
        return RxSO3(np.exp(tangent[3]), SO3.exp(tangent[:3]))

    def log(self) -> np.ndarray:
        return np.concatenate([self._rot.log(), [np.log(self._s)]])

    @property
    def scale(self) -> float:
        return self._s

    def so3(self) -> SO3:
        return self._rot

    def matrix(self) -> np.ndarray:
        return self._s * self._rot.matrix()

    def inverse(self) -> "RxSO3":
        return RxSO3(1.0 / self._s, self._rot.inverse())

    def act(self, points: np.ndarray) -> np.ndarray:
        return self._s * self._rot.act(points)

    def __mul__(self, other: "RxSO3") -> "RxSO3":
        return RxSO3(self._s * other._s, self._rot * other._rot)

    def __repr__(self):
        return f"RxSO3(scale={self._s}, quat_wxyz={self._rot.quaternion()})"


class Sim3:
    """Similarity transform group (sophus/sim3.hpp).

    Tangent = (upsilon, omega, sigma); x' = s*R*x + t. This is the type an
    ORB-SLAM3-class tracker emits at monocular loop closure.
    """

    DoF = 7

    def __init__(self, rxso3: RxSO3 | None = None,
                 translation: np.ndarray | None = None):
        self._rxso3 = rxso3 if rxso3 is not None else RxSO3()
        self._t = (np.zeros(3) if translation is None
                   else np.asarray(translation, np.float64))

    @staticmethod
    def exp(tangent: np.ndarray) -> "Sim3":
        tangent = np.asarray(tangent, np.float64)
        upsilon, omega, sigma = tangent[:3], tangent[3:6], float(tangent[6])
        theta = float(np.linalg.norm(omega))
        w = _calc_w(omega, theta, sigma)
        return Sim3(RxSO3(np.exp(sigma), SO3.exp(omega)), w @ upsilon)

    @staticmethod
    def from_scale_quat_trans(s: float, q_wxyz: np.ndarray,
                              t: np.ndarray) -> "Sim3":
        return Sim3(RxSO3(s, SO3.from_quaternion(q_wxyz)), t)

    def log(self) -> np.ndarray:
        omega_sigma = self._rxso3.log()
        omega, sigma = omega_sigma[:3], float(omega_sigma[3])
        theta = float(np.linalg.norm(omega))
        w = _calc_w(omega, theta, sigma)
        upsilon = np.linalg.solve(w, self._t)
        return np.concatenate([upsilon, omega, [sigma]])

    @property
    def scale(self) -> float:
        return self._rxso3.scale

    @property
    def translation(self) -> np.ndarray:
        return self._t.copy()

    def rxso3(self) -> RxSO3:
        return self._rxso3

    def so3(self) -> SO3:
        return self._rxso3.so3()

    def matrix(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = self._rxso3.matrix()
        m[:3, 3] = self._t
        return m

    def inverse(self) -> "Sim3":
        inv = self._rxso3.inverse()
        return Sim3(inv, -inv.act(self._t))

    def act(self, points: np.ndarray) -> np.ndarray:
        return self._rxso3.act(points) + self._t

    def to_se3(self) -> SE3:
        """Drop scale (the rigid part) — how a Sim3 correction is applied to
        camera poses while the scale goes into map-point positions."""
        return SE3(self.so3(), self._t)

    def __mul__(self, other: "Sim3") -> "Sim3":
        return Sim3(self._rxso3 * other._rxso3,
                    self._rxso3.act(other._t) + self._t)

    def __repr__(self):
        return (f"Sim3(scale={self.scale}, "
                f"quat_wxyz={self.so3().quaternion()}, t={self._t})")


def _generic_interpolate(a, b, t: float):
    return a * type(a).exp(t * (a.inverse() * b).log())


def interpolate(a, b, t: float):
    """Geodesic interpolation a * exp(t*log(a^-1 b)) for any group here
    (sophus/interpolate.hpp)."""
    return _generic_interpolate(a, b, float(t))
