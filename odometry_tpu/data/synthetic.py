"""Synthetic multi-view-consistent stereo scenes (procedural, exact GT).

The container has no datasets (zero egress), so tests and benchmarks render
procedural scenes with *exact* ground-truth pose, depth and disparity:

* The scene is a textured plane n . p = d in world coordinates with a smooth
  band-limited procedural texture (sum of random sinusoids of the world
  point) -> infinitely differentiable images with dense gradients, rendered
  consistently from any camera pose by exact ray-plane intersection.
* Stereo pairs are rendered with the right camera displaced by `baseline`
  along the left camera's +x axis (rectified geometry), so GT disparity is
  exactly fx * baseline / Z.

This plays the role of the reference's dataset-driven test fixtures
(``test_optimizer.cpp`` used TUM RGB-D sensor depth; ``test_disparity.cpp``
used Middlebury GT disparity) but with closed-form ground truth.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from odometry_tpu.camera.pinhole import Pinhole
from odometry_tpu.geometry import mat_to_rt

# Rendered frames must not depend on the device's default f32 matmul
# precision (TF32 on a GPU), or every frame differs between devices.
_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PlaneScene:
    """Textured plane n . p = d.

    texture(p) = sum_k amp_k sin(freq_k . p + phase_k)          (broadband base)
               + sum_j blob_amp_j exp(-|p - c_j|^2 / (2 s_j^2)) (sparse features)

    The Gaussian blobs create localized strong edges so blockwise
    median-plus-offset selection (depth_estimate.cpp:328-335) fires the way it
    does on natural images; the sinusoid base keeps gradients dense everywhere.
    """

    normal: jax.Array  # (3,) unit
    offset: jax.Array  # scalar d
    freqs: jax.Array  # (K, 3)
    amps: jax.Array  # (K,)
    phases: jax.Array  # (K,)
    blob_centers: jax.Array  # (J, 3)
    blob_inv2s2: jax.Array  # (J,) = 1 / (2 s_j^2)
    blob_amps: jax.Array  # (J,)
    # Ridged (turbulence) mix: 0 = pure smooth sinusoids; > 0 adds
    # sum_k ridge * amp_k * (|sin(.)| - 2/pi) — Perlin-style turbulence whose
    # creases (C0 gradient discontinuities at every zero crossing, at every
    # scale in the spectrum) mimic natural texture, unlike the infinitely
    # smooth base. Scalar leaf so existing scenes (ridge=0) are unchanged.
    ridge: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(0.0))

    def texture(self, p: jax.Array) -> jax.Array:
        """p: (..., 3) world points -> intensity in roughly [0, 255]."""
        phase = _einsum("kj,...j->...k", self.freqs, p) + self.phases
        s = jnp.sin(phase)
        val = _einsum("k,...k->...", self.amps, s)
        val = val + self.ridge * _einsum(
            "k,...k->...", self.amps, jnp.abs(s) - (2.0 / jnp.pi))
        diff = p[..., None, :] - self.blob_centers  # (..., J, 3)
        r2 = jnp.sum(diff * diff, axis=-1)
        val = val + _einsum("j,...j->...", self.blob_amps, jnp.exp(-r2 * self.blob_inv2s2))
        return 127.5 + val


def make_scene(
    seed: int = 0,
    *,
    num_waves: int = 48,
    num_blobs: int = 600,
    depth: float = 12.0,
    tilt: float = 0.15,
    freq_scale: float = 8.0,
    contrast: float = 55.0,
) -> PlaneScene:
    """A mildly tilted plane ~`depth` meters in front of the z-axis camera.

    `contrast` is the approximate intensity standard deviation; the defaults
    produce image gradients strong enough for the reference's adaptive
    selection thresholds (median + 8) to fire.

    Pick ``freq_scale`` so the finest wavelength (2*pi / (2*freq_scale))
    stays >= ~8 pixel footprints (depth/fx meters per pixel at the working
    distance) — beyond that the texture aliases and stereo matching develops
    periodic false minima no real matcher could avoid.
    """
    rng = np.random.default_rng(seed)
    n = np.array([tilt * rng.standard_normal(), tilt * rng.standard_normal(), -1.0])
    n = n / np.linalg.norm(n)
    # Broad-band spectrum (log-uniform magnitudes over ~1.2 decades, random
    # directions, 1/f-ish amplitude falloff): non-repeating texture so
    # accidental full-search stereo matches are rare.
    dirs = rng.standard_normal((num_waves, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    mags = np.exp(rng.uniform(np.log(0.125 * freq_scale), np.log(2.0 * freq_scale), num_waves))
    freqs = dirs * mags[:, None]
    amps = rng.uniform(0.5, 1.0, num_waves) * (mags / mags.min()) ** -0.35
    # Random-phase sinusoid sum has variance sum(a_k^2)/2; scale to `contrast`.
    amps = amps * (contrast / np.sqrt(np.sum(amps**2) / 2.0))
    phases = rng.uniform(0, 2 * np.pi, num_waves)
    d = float(n @ np.array([0.0, 0.0, depth]))
    # Sparse blob features scattered over the visible patch of the plane.
    # Extent scales with working distance (FOV ~ +-0.9 * depth laterally for
    # wide sweeps); widths span sharp-edge to soft-shadow scales.
    extent = 1.5 * depth
    nb = max(num_blobs, 1)  # keep array shapes non-empty; amps zeroed if unused
    centers = np.zeros((nb, 3))
    centers[:, 0] = rng.uniform(-extent, extent, nb)
    centers[:, 1] = rng.uniform(-0.5 * depth, 0.5 * depth, nb)
    # Project centers onto the plane along z.
    centers[:, 2] = (d - centers[:, 0] * n[0] - centers[:, 1] * n[1]) / n[2]
    widths = np.exp(rng.uniform(np.log(0.10), np.log(0.5), nb))
    blob_amps = rng.uniform(40.0, 90.0, nb) * rng.choice([-1.0, 1.0], nb)
    if num_blobs == 0:
        blob_amps[:] = 0.0
    return PlaneScene(
        normal=jnp.asarray(n, jnp.float32),
        offset=jnp.asarray(d, jnp.float32),
        freqs=jnp.asarray(freqs, jnp.float32),
        amps=jnp.asarray(amps, jnp.float32),
        phases=jnp.asarray(phases, jnp.float32),
        blob_centers=jnp.asarray(centers, jnp.float32),
        blob_inv2s2=jnp.asarray(1.0 / (2.0 * widths**2), jnp.float32),
        blob_amps=jnp.asarray(blob_amps, jnp.float32),
    )


def render(
    scene: PlaneScene,
    cam: Pinhole,
    T_wc: jax.Array,
    height: int,
    width: int,
):
    """Render image + depth from camera pose T_wc (camera-to-world).

    Returns (image (H, W), z_depth (H, W)) — z_depth is the camera-frame Z of
    the plane point behind each pixel (inf-free; plane assumed in front).
    """
    R, t = mat_to_rt(T_wc)
    ys = jax.lax.broadcasted_iota(jnp.float32, (height, width), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (height, width), 1)
    # Camera-frame ray with unit z.
    rx = (xs - cam.cx) / cam.fx
    ry = (ys - cam.cy) / cam.fy
    # World-frame ray and origin.
    rw = jnp.stack(
        [
            R[0, 0] * rx + R[0, 1] * ry + R[0, 2],
            R[1, 0] * rx + R[1, 1] * ry + R[1, 2],
            R[2, 0] * rx + R[2, 1] * ry + R[2, 2],
        ],
        axis=-1,
    )
    if isinstance(scene, MultiPlaneScene):
        # Nearest positive intersection over all planes.
        denom = _einsum("pj,...j->...p", scene.normals, rw)  # (..., P)
        num = scene.offsets - _einsum("pj,j->p", scene.normals, t)  # (P,)
        tp = num / jnp.where(jnp.abs(denom) < 1e-9, 1e-9, denom)
        tp = jnp.where(tp > 0.05, tp, jnp.float32(jnp.inf))
        tstar = jnp.min(tp, axis=-1)
        tstar = jnp.where(jnp.isfinite(tstar), tstar, jnp.float32(100.0))
    else:
        n = scene.normal
        denom = _einsum("j,...j->...", n, rw)
        denom = jnp.where(jnp.abs(denom) < 1e-9, 1e-9, denom)
        tstar = (scene.offset - _einsum("j,j->", n, t)) / denom
    p = t + tstar[..., None] * rw
    img = scene.texture(p)
    return img, tstar  # Z == tstar because the camera ray has unit z


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MultiPlaneScene:
    """Several textured planes composited by nearest positive ray intersection.

    A single plane is pose-degenerate for SE(3) photometric alignment (the
    plane-induced-homography ambiguity leaves near-null directions in the 6x6
    normal equations, so float32 solver noise is amplified ~1/sigma_min). A
    ground plane plus walls at different depths/orientations conditions the
    system the way real street scenes do — required for trajectory-level
    parity tests where two faithful implementations must stay on the same LM
    path. Texture is a single function of the world point (same broadband
    sinusoid + blob construction as :class:`PlaneScene`), so every plane shows
    a different slice of it; occlusions are consistent across views because
    both eyes composite the true nearest surface.
    """

    normals: jax.Array  # (P, 3) unit normals
    offsets: jax.Array  # (P,) plane offsets: n . p = d
    freqs: jax.Array
    amps: jax.Array
    phases: jax.Array
    blob_centers: jax.Array
    blob_inv2s2: jax.Array
    blob_amps: jax.Array
    ridge: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.float32(0.0))

    texture = PlaneScene.texture


def make_driving_scene(
    seed: int = 0,
    *,
    ground_y: float = 1.6,
    wall_z: float = 16.0,
    side_x: float = 5.0,
    num_waves: int = 48,
    num_blobs: int = 500,
    freq_scale: float = 6.0,
    contrast: float = 55.0,
) -> MultiPlaneScene:
    """Street-like scene: ground plane + front wall + two side walls.

    Camera convention: +z forward, +y down (pinhole image coords), so the
    ground plane is y = `ground_y` below a camera at the origin. Depths seen
    by a forward-looking camera span ~[3, 25] m — inside the reference's
    [0.1, 30] validity band (run_odometry_kitti_offline.cpp:62-63).
    """
    rng = np.random.default_rng(seed)
    jig = lambda s: 1.0 + 0.08 * rng.standard_normal(s)  # break exact symmetry
    normals = np.array(
        [
            [0.0, 1.0, 0.02 * rng.standard_normal()],  # ground (y = ground_y)
            [0.03 * rng.standard_normal(), 0.0, 1.0],  # front wall (z = wall_z)
            [1.0, 0.0, 0.12 * jig(())],                # right wall
            [-1.0, 0.0, 0.12 * jig(())],               # left wall
        ]
    )
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    anchor = np.array(
        [
            [0.0, ground_y, 0.0],
            [0.0, 0.0, wall_z * jig(())],
            [side_x * jig(()), 0.0, 0.0],
            [-side_x * jig(()), 0.0, 0.0],
        ]
    )
    offsets = np.einsum("pj,pj->p", normals, anchor)

    dirs = rng.standard_normal((num_waves, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    mags = np.exp(rng.uniform(np.log(0.125 * freq_scale), np.log(2.0 * freq_scale), num_waves))
    freqs = dirs * mags[:, None]
    amps = rng.uniform(0.5, 1.0, num_waves) * (mags / mags.min()) ** -0.35
    amps = amps * (contrast / np.sqrt(np.sum(amps**2) / 2.0))
    phases = rng.uniform(0, 2 * np.pi, num_waves)
    # Blobs scattered through the visible volume (walls/ground pick up the
    # ones lying near their surface).
    nb = max(num_blobs, 1)
    centers = np.stack(
        [
            rng.uniform(-side_x, side_x, nb),
            rng.uniform(-2.0, ground_y, nb),
            rng.uniform(1.0, wall_z, nb),
        ],
        axis=1,
    )
    widths = np.exp(rng.uniform(np.log(0.10), np.log(0.5), nb))
    blob_amps = rng.uniform(40.0, 90.0, nb) * rng.choice([-1.0, 1.0], nb)
    if num_blobs == 0:
        blob_amps[:] = 0.0
    return MultiPlaneScene(
        normals=jnp.asarray(normals, jnp.float32),
        offsets=jnp.asarray(offsets, jnp.float32),
        freqs=jnp.asarray(freqs, jnp.float32),
        amps=jnp.asarray(amps, jnp.float32),
        phases=jnp.asarray(phases, jnp.float32),
        blob_centers=jnp.asarray(centers, jnp.float32),
        blob_inv2s2=jnp.asarray(1.0 / (2.0 * widths**2), jnp.float32),
        blob_amps=jnp.asarray(blob_amps, jnp.float32),
    )


def make_natural_scene(
    seed: int = 0,
    *,
    num_waves: int = 72,
    num_blobs: int = 500,
    depth: float = 14.0,
    tilt: float = 0.15,
    freq_scale: float = 8.0,
    contrast: float = 55.0,
    ridge: float = 1.0,
) -> PlaneScene:
    """Natural-texture plane: multi-octave ridged (turbulence) spectrum.

    Differences vs :func:`make_scene`, chosen to stress what clean sinusoids
    cannot (the stand-in for the real-image validation the reference had —
    TUM RGB-D in ``test_optimizer.cpp:23-26``, Middlebury in
    ``test_disparity.cpp:17``):

    * spectrum spans ~2.3 decades (vs 1.2) with a steeper 1/f falloff —
      energy at many scales simultaneously, like outdoor imagery;
    * `ridge` mixes in Perlin-style turbulence ``|sin|`` terms whose creases
      put C0 gradient discontinuities at every scale — bilinear sampling and
      central-difference gradients are only approximations there;
    * amplitude is calibrated NUMERICALLY to `contrast` (the analytic
      random-phase formula does not hold once |sin| terms correlate).
    """
    rng = np.random.default_rng(seed)
    n = np.array([tilt * rng.standard_normal(), tilt * rng.standard_normal(), -1.0])
    n = n / np.linalg.norm(n)
    dirs = rng.standard_normal((num_waves, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    # ~1.5 decades with a ~1/f amplitude falloff (natural-image statistics;
    # a flatter spectrum over-weights high frequencies relative to any real
    # scene and makes the fixture measure the renderer, not the presets).
    mags = np.exp(rng.uniform(np.log(0.08 * freq_scale), np.log(2.5 * freq_scale), num_waves))
    freqs = dirs * mags[:, None]
    amps = rng.uniform(0.5, 1.0, num_waves) * (mags / mags.min()) ** -0.9
    phases = rng.uniform(0, 2 * np.pi, num_waves)
    d = float(n @ np.array([0.0, 0.0, depth]))
    # Numeric LOCAL-contrast calibration: std over a camera-footprint-sized
    # patch (the waves below the patch scale act as DC locally, so a
    # whole-plane std would overstate the usable gradient contrast).
    span = 0.25 * depth
    px = rng.uniform(-span, span, (4096, 1))
    py = rng.uniform(-span, span, (4096, 1))
    pz = (d - px * n[0] - py * n[1]) / n[2]
    pts = np.concatenate([px, py, pz], axis=1)
    s = np.sin(pts @ freqs.T + phases)
    val = s @ amps + ridge * ((np.abs(s) - 2.0 / np.pi) @ amps)
    amps = amps * (contrast / max(float(val.std()), 1e-6))

    extent = 1.5 * depth
    nb = max(num_blobs, 1)
    centers = np.zeros((nb, 3))
    centers[:, 0] = rng.uniform(-extent, extent, nb)
    centers[:, 1] = rng.uniform(-0.5 * depth, 0.5 * depth, nb)
    centers[:, 2] = (d - centers[:, 0] * n[0] - centers[:, 1] * n[1]) / n[2]
    widths = np.exp(rng.uniform(np.log(0.10), np.log(0.5), nb))
    # Feature density matches the plane family's (real outdoor scenes are
    # corner/edge-rich; a feature-poor fixture measures the renderer's
    # sparseness, not the presets' texture robustness).
    blob_amps = rng.uniform(40.0, 90.0, nb) * rng.choice([-1.0, 1.0], nb)
    if num_blobs == 0:
        blob_amps[:] = 0.0
    return PlaneScene(
        normal=jnp.asarray(n, jnp.float32),
        offset=jnp.asarray(d, jnp.float32),
        freqs=jnp.asarray(freqs, jnp.float32),
        amps=jnp.asarray(amps, jnp.float32),
        phases=jnp.asarray(phases, jnp.float32),
        blob_centers=jnp.asarray(centers, jnp.float32),
        blob_inv2s2=jnp.asarray(1.0 / (2.0 * widths**2), jnp.float32),
        blob_amps=jnp.asarray(blob_amps, jnp.float32),
        ridge=jnp.float32(ridge),
    )


@dataclasses.dataclass(frozen=True)
class PhotometricNuisance:
    """Camera/exposure imperfections applied to rendered frames (host side).

    The reference validated on real sensors whose images carry exactly these
    nuisances; the renderer is otherwise photometrically perfect. All effects
    are deterministic in (seed, frame index, eye).

    * ``gain_amp`` / ``bias_amp``: smooth sinusoidal auto-exposure drift over
      ``drift_period`` frames — multiplicative gain 1 +- gain_amp and additive
      offset +- bias_amp gray levels, SHARED by the two eyes of a pair (one
      exposure controller), challenging keyframe-relative tracking.
    * ``eye_gain_mismatch``: constant relative gain between left and right
      sensors — stresses the SSD stereo matcher.
    * ``vignette``: radial intensity falloff, ``1 - vignette * r_corner^2``.
      The default 6% models the RESIDUAL after lens-shading correction
      (uncorrected lenses reach 30%+; calibrated automotive rigs like
      KITTI's ship corrected frames).
    * ``noise_sigma``: i.i.d. Gaussian sensor noise, independent per eye/frame.
    """

    gain_amp: float = 0.06
    bias_amp: float = 6.0
    noise_sigma: float = 1.5
    vignette: float = 0.06
    eye_gain_mismatch: float = 0.02
    drift_period: float = 40.0
    seed: int = 0


def apply_nuisance(
    img: np.ndarray, frame_idx: int, nuisance: PhotometricNuisance, eye: int = 0
) -> np.ndarray:
    """Apply the nuisance model to one rendered frame (numpy, host side)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    rng = np.random.default_rng((nuisance.seed, 7919))
    gain_phase = rng.uniform(0, 2 * np.pi)
    bias_phase = rng.uniform(0, 2 * np.pi)
    ang = 2.0 * np.pi * frame_idx / nuisance.drift_period
    gain = 1.0 + nuisance.gain_amp * np.sin(ang + gain_phase)
    bias = nuisance.bias_amp * np.sin(ang + bias_phase)
    if eye == 1:
        gain *= 1.0 + nuisance.eye_gain_mismatch
    ys = (np.arange(h, dtype=np.float32)[:, None] - h / 2.0) / (h / 2.0)
    xs = (np.arange(w, dtype=np.float32)[None, :] - w / 2.0) / (w / 2.0)
    r2 = (ys * ys + xs * xs) / 2.0  # corner => 1
    out = (127.5 + gain * (img - 127.5) + bias) * (1.0 - nuisance.vignette * r2)
    noise_rng = np.random.default_rng((nuisance.seed, frame_idx, eye))
    out = out + noise_rng.normal(0.0, nuisance.noise_sigma, img.shape)
    return out.astype(np.float32)


def right_camera_pose(T_wc_left: jax.Array, baseline: float) -> jax.Array:
    """Rectified right camera: displaced by +baseline along the left cam x-axis."""
    R, t = mat_to_rt(T_wc_left)
    offset = R[:, 0] * baseline
    return T_wc_left.at[:3, 3].set(t + offset)


def render_stereo(
    scene: PlaneScene,
    cam: Pinhole,
    baseline: float,
    T_wc: jax.Array,
    height: int,
    width: int,
):
    """Render a rectified stereo pair + left depth. Returns (left, right, z)."""
    left, z = render(scene, cam, T_wc, height, width)
    right, _ = render(scene, cam, right_camera_pose(T_wc, baseline), height, width)
    return left, right, z


def drive_trajectory(
    num_frames: int,
    *,
    step: float = 0.3,
    forward_frac: float = 0.15,
    yaw_rate: float = 0.002,
    seed: int = 0,
) -> np.ndarray:
    """Lateral-dominant driving poses (N, 4, 4), cam-to-world.

    The single-plane scene sits ~12 m ahead along +z, so sequences translate
    mostly along x (driving parallel to a wall) with mild forward drift and
    yaw — KITTI-scale optical flow without ever reaching the surface.
    """
    from odometry_tpu.geometry import se3_exp
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    T = np.eye(4, dtype=np.float32)
    poses = [T.copy()]
    for _ in range(num_frames - 1):
        twist = np.array(
            [
                step * (1.0 + 0.1 * rng.standard_normal()),
                0.05 * step * rng.standard_normal(),
                forward_frac * step * rng.standard_normal(),
                0.2 * yaw_rate * rng.standard_normal(),
                yaw_rate * rng.standard_normal(),
                0.2 * yaw_rate * rng.standard_normal(),
            ],
            np.float32,
        )
        delta = np.asarray(se3_exp(jnp.asarray(twist)))
        T = (T @ delta).astype(np.float32)
        poses.append(T.copy())
    return np.stack(poses)


def stereo_sequence(
    scene: PlaneScene,
    cam: Pinhole,
    baseline: float,
    poses: np.ndarray,
    height: int,
    width: int,
):
    """Yield (left, right) numpy pairs along a trajectory (jitted renderer)."""
    f = jax.jit(
        lambda T: render_stereo(scene, cam, baseline, T, height, width),
        static_argnames=(),
    )
    for T in poses:
        left, right, _ = f(jnp.asarray(T))
        yield np.asarray(left), np.asarray(right)
