"""husky_rover_mppi — a JAX MPPI rover-navigation framework.

A brand-new JAX / XLA / Pallas implementation of the capabilities of
Nathan494326/Husky-Rover-MPPI-IsaacSim (an OmniLRS fork + MPPI thesis stack):

- ``core``      — heightfield (DEM) geometry ops: corner gathers, bilinear
                  interpolation, quad normals, tangent projection (reference:
                  ``thesis_master/warp_implementation/projection_warp.py``).
- ``dynamics``  — Husky skid-steer wheel-lag model and diff-drive mapping
                  (reference: ``sampling_warp.py:96-139``).
- ``mppi``      — the MPPI controller: input sampling, 2.5D surface rollouts,
                  critic stack, importance-weighted update (reference:
                  ``MPPI_isaac.py``, ``critics_warp.py``).
- ``terrain``   — procedural lunar terrain: analytic surfaces, obstacle
                  costmaps with exact Euclidean distance transforms, crater
                  generation, DEM upsampling, block streaming.
- ``worldbuilders`` — procedural sampling library (point processes, layers,
                  clippers, mixer) re-expressed as pure JAX ops.
- ``env``       — vectorized closed-loop rover environments (many rovers in
                  lockstep) replacing the Isaac Sim / PhysX shell.
- ``parallel``  — device-mesh sharding of (rover, sample) axes with XLA
                  collectives.
- ``compat``    — NumPy reference oracles used for bit-match testing
                  (reference: ``thesis_master/python_mppi_projection/``).
- ``ops``       — compute kernels (a Pallas GPU kernel + XLA ops) backing the
                  hot paths.

Nothing in this package is a port: the reference's CUDA/Warp SIMT kernels are
re-designed as batched, jit-compiled functional transforms (vmap over samples,
``lax.scan`` over the horizon, psum over sharded sample axes).
"""

__version__ = "0.1.0"
