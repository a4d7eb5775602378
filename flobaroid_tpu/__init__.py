"""flobaroid_tpu — floating-base robot dynamics identification in JAX.

A ground-up JAX/XLA rebuild of the FloBaRoID toolkit
(reference: kjyv/FloBaRoID): identification of inertial + friction
parameters of fixed- and floating-base rigid-body robots from joint
torque / base-wrench measurements, including excitation-trajectory
optimization, differentiable measurement simulation, physically
consistent (SDP-constrained) estimation and reporting.

Design (accelerator-first, not a port):
  * the per-sample iDynTree inverse-dynamics/regressor loop of the
    reference (identification/model.py:333) becomes one pure-JAX
    function vmapped over all trajectory samples,
  * Y^T W Y / Y^T tau Gram accumulation streams over device-resident
    sample chunks (XLA einsums at HIGHEST precision inside one scan),
  * gradients of everything (D-optimal trajectory design, friction
    models, measurement effects) come from jax.grad instead of the
    reference's finite differences + multiprocessing pools,
  * multi-chip scaling shards the sample axis of the Gram/objective
    over a jax.sharding.Mesh (`flobaroid_tpu.parallel`).

File formats (YAML config, URDF models, npz trajectories/measurements)
stay byte-compatible with the reference.
"""

__version__ = "0.1.0"
