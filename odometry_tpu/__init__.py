"""odometry_tpu — a direct stereo semi-dense visual odometry / SLAM engine.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
C++ system (WangYuTum/odometry): stereo semi-dense inverse-depth estimation,
coarse-to-fine direct photometric SE(3) tracking, keyframing, mapping with
windowed bundle adjustment, and multi-device scaling via jax.sharding meshes.

Layers (bottom-up):
  geometry/     pure-JAX SE(3)/SO(3) (replaces vendored Sophus)
  camera/       pinhole model + calibration + rectification as data
  image/        pyramids, gradients, sampling (replaces OpenCV image ops)
  kernels/      hot compute kernels (jnp; a Pallas/Triton stereo search on GPU)
  solvers/      Levenberg-Marquardt engines as lax.while_loop
  depth/        stereo disparity search + inverse-depth refinement frontend
  tracking/     coarse-to-fine direct photometric pose tracker
  pipeline/     jittable odometry step + host runner + keyframe policy
  mapping/      keyframe ring buffer, windowed photometric BA, pose graph
  distributed/  mesh utilities, multi-sequence sweeps, sharded BA
  data/         KITTI / TUM RGB-D / Middlebury loaders + synthetic scenes
  eval/         ATE/RPE metrics, KITTI-devkit export
  utils/        config, profiling, checkpointing
"""

__version__ = "0.1.0"
